"""Every kernel library's ctypes table agrees with its C sources.

``_build.Library`` sets each entry's ctypes argument types from its table:
``functions`` entries take (pointers, ints) and the stream last, ``workspace``
entries take ints and return a size_t, ``queries`` take ints and return a
long long. A pointer passed where the C function takes an int (or the other
way round) is cut or shifted, and that shows only on the card. Here the
``extern "C"`` definitions in each library's sources are parsed and held
against the table, for every library of the port.
"""

import importlib
import os
import pkgutil
import re

import pytest

import jittor_mlp_tpu_torch.ops.kernels as kernels_pkg
from jittor_mlp_tpu_torch.ops.kernels import _build

CSRC = _build._CSRC
_EXTERN = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _libraries():
    """name → Library, for every Library held by a module of ops/kernels."""
    libs = {}
    for info in pkgutil.iter_modules(kernels_pkg.__path__):
        mod = importlib.import_module(f"{kernels_pkg.__name__}.{info.name}")
        for value in vars(mod).values():
            found = value.values() if isinstance(value, dict) else [value]
            for lib in found:
                if isinstance(lib, _build.Library):
                    libs[lib.name] = lib
    return libs


LIBRARIES = _libraries()


def _externs(lib):
    """C name → (return type, [parameter declarations]) over the library's sources."""
    out = {}
    for src in lib.sources:
        with open(os.path.join(CSRC, src)) as f:
            text = f.read()
        for ret, name, params in _EXTERN.findall(text):
            decls = [" ".join(p.split()) for p in params.split(",") if p.strip()]
            out[name] = (" ".join(ret.split()), decls)
    return out


def _kind(decl):
    if "*" in decl:
        return "ptr"
    if re.match(r"^(const\s+)?int\s+\w+$", decl):
        return "int"
    return decl


def test_every_library_is_found():
    assert {"mixer_block", "mixer_block_bwd", "gemm_sm90", "lab_ablate", "lab_tokmajor",
            "lab_wide", "axial_shift", "gmlp_block_int8", "mixer_block_int8",
            "gmlp_block"} <= set(LIBRARIES)


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_sources_and_error_entry_exist(name):
    lib = LIBRARIES[name]
    for src in lib.sources:
        assert os.path.isfile(os.path.join(CSRC, src)), src
    ret, params = _externs(lib)[lib.error]
    assert ret == "const char*" and [_kind(p) for p in params] == ["int"], (ret, params)


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_launch_entries_match_their_c_parameters(name):
    lib = LIBRARIES[name]
    externs = _externs(lib)
    assert lib.functions
    for fn, (n_ptr, n_int) in lib.functions.items():
        assert fn in externs, f"{fn} is not an extern \"C\" function of {lib.sources}"
        ret, params = externs[fn]
        kinds = [_kind(p) for p in params]
        assert ret == "int", (fn, ret)
        assert params[-1].startswith("void*") and "stream" in params[-1], (fn, params[-1])
        assert kinds[:-1] == ["ptr"] * n_ptr + ["int"] * n_int, (fn, kinds, n_ptr, n_int)


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_size_and_count_queries_match_their_c_parameters(name):
    lib = LIBRARIES[name]
    externs = _externs(lib)
    for table, want_ret in ((lib.workspace_fns, "size_t"), (lib.queries, "long long")):
        for fn, n_int in table.items():
            assert fn in externs, f"{fn} is not an extern \"C\" function of {lib.sources}"
            ret, params = externs[fn]
            assert ret == want_ret and [_kind(p) for p in params] == ["int"] * n_int, (
                fn, ret, params)
    if lib.routes_fn is not None:
        assert lib.queries[lib.routes_fn] == 1


def test_channel_product_libraries_count_their_routes():
    # every library whose sources run gemm_sm90.cuh's products (gemm_tn,
    # gemm_bf16, gemm_s8) names its count, of the routes of its operands' type
    for lib in LIBRARIES.values():
        text = "".join(open(os.path.join(CSRC, s)).read() for s in lib.sources)
        s8 = "gemm_s8(" in text
        uses = s8 or "gemm_tn(" in text or "gemm_bf16<" in text or \
            '#include "mixer_forward.cuh"' in text or '#include "lab_block.cuh"' in text
        assert (lib.routes_fn is not None) == uses, lib.name
        if uses and lib.name != "gemm_sm90":  # the checking library runs both types
            want = _build.S8_ROUTES if s8 else _build.BF16_ROUTES
            assert lib.route_names == want, (lib.name, lib.route_names)


def test_mode_entries_and_queries_are_in_the_tables():
    # the core's dual and Group modes: the checking entries of gemm_sm90 and
    # the Mixer backward library's launch count per mode, each listed (and
    # so held against its C parameters by the tests above)
    core, bwd = LIBRARIES["gemm_sm90"], LIBRARIES["mixer_block_bwd"]
    assert core.functions["gemm_bf16_dual_f32"] == (5, 11)
    assert core.functions["gemm_bf16_group_f32"] == (3, 6)
    assert bwd.queries["mixer_bwd_mode_launches"] == 1
    assert "mixer_token_bwd_images_per_group" in bwd.workspace_fns
