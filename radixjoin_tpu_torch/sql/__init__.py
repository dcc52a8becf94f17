from .catalog import ATTRIBUTES, COLUMN_TO_TABLES, column_index, column_type
from .frontend import ParsedSQL, TableEntity
from .explain import plan_from_explain

__all__ = [
    "ATTRIBUTES",
    "COLUMN_TO_TABLES",
    "column_index",
    "column_type",
    "ParsedSQL",
    "TableEntity",
    "plan_from_explain",
]
