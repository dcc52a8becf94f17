from .columnar import Column, ColumnarTable, HostColumn, HostTable

__all__ = ["Column", "ColumnarTable", "HostColumn", "HostTable"]
