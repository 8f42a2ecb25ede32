"""bullet_tpu — a peer-network graph database framework with a JAX engine.

Capability twin of bullet-js (KORandi/bullet-js, mounted read-only at
/root/reference): the host ``db`` layer is a drop-in for the reference API;
the ``models``/``ops``/``parallel`` packages are the jit-compiled simulation
engine (dense tables, an XLA CRT merge, collective gossip over a device
mesh). See DESIGN.md.

Package entry mirrors /root/reference/index.js: default ``Bullet``, named
component exports, a ``create`` factory, and ``VERSION``.
"""

from .db.core import Bullet, BulletNode
from .db.crt import BulletCRT
from .db.middleware import BulletMiddleware
from .db.query import BulletQuery
from .db.serializer import BulletSerializer
from .db.storage import BulletMemoryStorage, BulletStorage
from .db.validation import BulletValidation, ValidationError

VERSION = "0.1.0"

# reference-style component aliases (index.js:8-14)
Storage = BulletStorage
Query = BulletQuery
Validation = BulletValidation
Middleware = BulletMiddleware
Serializer = BulletSerializer


def create(options=None) -> Bullet:
    """Factory mirroring ``module.exports.create`` (index.js:20)."""
    return Bullet(options)


def __getattr__(name):
    # heavyweight / optional components resolved lazily so importing the
    # package never drags in jax or the network stack unnecessarily
    if name == "Network":
        from .db.network import BulletNetwork

        return BulletNetwork
    if name == "FileStorage":
        from .db.file_storage import BulletFileStorage

        return BulletFileStorage
    if name == "PeerNetworkSim":
        from .models.netsim import PeerNetworkSim

        return PeerNetworkSim
    if name in ("P", "Predicate"):
        from .ops import predicates

        return getattr(predicates, name)
    raise AttributeError(name)


__all__ = [
    "Bullet",
    "BulletNode",
    "BulletCRT",
    "create",
    "VERSION",
    "Storage",
    "FileStorage",
    "Network",
    "Query",
    "Validation",
    "Middleware",
    "Serializer",
    "PeerNetworkSim",
    "P",
    "Predicate",
]
