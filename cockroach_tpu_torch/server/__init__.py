"""Node server + pgwire SQL API (reference: pkg/server, pkg/sql/pgwire).

Lazy exports (PEP 562): importing the package does not import the
engine."""

__all__ = ["Node", "NodeConfig", "PgServer"]

_EXPORTS = {"Node": ("cockroach_tpu_torch.server.node", "Node"),
            "NodeConfig": ("cockroach_tpu_torch.server.node", "NodeConfig"),
            "PgServer": ("cockroach_tpu_torch.server.pgwire", "PgServer")}


def __getattr__(name):
    try:
        mod, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib
    return getattr(importlib.import_module(mod), attr)
