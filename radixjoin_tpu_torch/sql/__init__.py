from .catalog import ATTRIBUTES, COLUMN_TO_TABLES, column_index, column_type

__all__ = ["ATTRIBUTES", "COLUMN_TO_TABLES", "column_index", "column_type"]
