"""Table descriptors stored transactionally in the KV plane (the system
of record for columns, indexes, CHECK and FOREIGN KEY constraints and
column defaults) and the descriptor leases of online schema changes."""

from .catalog import Catalog, CatalogError
from .descriptor import ColumnDescriptor, IndexDescriptor, TableDescriptor
from .lease import LeasedDescriptor, LeaseManager

__all__ = ["Catalog", "CatalogError", "TableDescriptor",
           "ColumnDescriptor", "IndexDescriptor", "LeaseManager",
           "LeasedDescriptor"]
