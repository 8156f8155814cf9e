"""Serving: export of the sampling program (port of ``fdtpu/serve``).

:func:`load_exported` needs only torch and the kernels' operator
registrations; :func:`make_sampling_fn` and :func:`export_sampler` need the
sampler, so they are imported at their first use.
"""

from fdtpu_torch.serve.load import load_exported

__all__ = ["export_sampler", "load_exported", "make_sampling_fn"]


def __getattr__(name: str):
    if name in ("export_sampler", "make_sampling_fn"):
        from fdtpu_torch.serve import export

        return getattr(export, name)
    raise AttributeError(f"module 'fdtpu_torch.serve' has no attribute {name!r}")
