from .tools import check_sizes, pair, sized_kwargs

__all__ = ["check_sizes", "pair", "sized_kwargs"]
