from .tools import check_sizes, pair

__all__ = ["check_sizes", "pair"]
