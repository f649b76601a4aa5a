"""Host-side task parallelism (ingest's fan-out over processes and hosts)
and data-parallel groups on ``torch.distributed`` (``mesh``).

``mesh``'s names load on first use: ingest's command line and its spawned
workers import ``map`` alone, without torch."""
from .map import parallelise, shard_across_hosts

_MESH = (
    'DATA_AXIS',
    'MODEL_AXIS',
    'Mesh',
    'batch_sharding',
    'global_batch_from_local',
    'local_batch_size',
    'make_mesh',
    'maybe_initialize_distributed',
    'replicate',
    'replicated',
    'shard_batch',
    'spawn',
    'warmup_collectives',
)

__all__ = ['parallelise', 'shard_across_hosts', *_MESH]


def __getattr__(name):
    if name in _MESH:
        from . import mesh

        return getattr(mesh, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
