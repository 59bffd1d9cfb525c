"""Data parallelism on torch.distributed: the counterparts of the JAX
`parallel` package's `__all__` that exist here, imported from `dist.py` at
first use (`_lazy.py`).

`make_mesh`, `batch_sharding` and `replicated_sharding` have no
counterpart: there is no mesh under torch.distributed.  A process group of
one rank a card takes the mesh's place (`dist.init_distributed`), and a
batch is sharded by slicing it per rank (`shard_batch`), not by a sharding
object."""

from mod_extraction_tpu_torch._lazy import lazy_exports

_EXPORTS = {"put_replicated": "dist", "shard_batch": "dist"}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
