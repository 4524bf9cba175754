from .cache import ladder_lookup, ladder_store, next_rung

__all__ = ["ladder_lookup", "ladder_store", "next_rung"]
