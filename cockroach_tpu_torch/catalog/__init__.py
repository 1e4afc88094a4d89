"""Table descriptors stored transactionally in the KV plane: the
system of record for CHECK and FOREIGN KEY constraints and column
defaults."""

from .catalog import Catalog, CatalogError
from .descriptor import ColumnDescriptor, IndexDescriptor, TableDescriptor

__all__ = ["Catalog", "CatalogError", "TableDescriptor",
           "ColumnDescriptor", "IndexDescriptor"]
