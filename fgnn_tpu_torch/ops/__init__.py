from .typed_mp import Extension, GatherTable, aggregate, typed_mp_conv

__all__ = ["Extension", "GatherTable", "aggregate", "typed_mp_conv"]
