from .merge import TableState, init_table, merge_tables_xla
from .apply import OpBatch, apply_ops

__all__ = [
    "TableState",
    "init_table",
    "merge_tables_xla",
    "OpBatch",
    "apply_ops",
]
