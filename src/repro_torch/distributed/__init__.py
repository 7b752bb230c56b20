"""The distribution layer (the JAX package's ``repro.distributed``): a
rank's view of the mesh over the port's ``Comm`` (``context``), the
sharding specs as a placement model (``sharding``), the cMPI gradient
schedule and train step (``schedules``), int8 compression
(``compression``) and host-side coordination (``host_coord``).

Exports are lazy (PEP 562), with the same names as the JAX package's:
importing this package loads nothing of the model stack, so a
host-side rank (a data loader, a checkpoint writer) can import
``host_coord``'s names from here alone."""
_CONTEXT = ("DistContext",)
_SHARDING = ("batch_pspecs", "decode_state_pspecs", "opt_state_pspecs",
             "param_pspecs")
_HOST_COORD = ("agree_max_step", "allreduce_metrics", "bcast_manifest",
               "sync_epoch")

__all__ = [*_CONTEXT, *_SHARDING, *_HOST_COORD]


def __getattr__(name):
    if name in _CONTEXT:
        from repro_torch.distributed import context
        return getattr(context, name)
    if name in _SHARDING:
        from repro_torch.distributed import sharding
        return getattr(sharding, name)
    if name in _HOST_COORD:
        from repro_torch.distributed import host_coord
        return getattr(host_coord, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
