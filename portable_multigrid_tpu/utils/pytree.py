"""Pytree-registered dataclass helpers.

The whole solver stack (operators, smoothers, transfers, V-cycle) is expressed
as immutable dataclasses whose array fields are pytree leaves and whose shape/
degree/dimension fields are static metadata.  This lets a full multigrid
hierarchy be passed straight through ``jax.jit`` — the JAX replacement
for the reference's virtual-dispatch `LaplaceOperatorBase` hierarchy
(reference: include/base/portable_laplace_operator_base.h:16-96, where a
compile-time template dispatch bridges runtime degree to instantiations; here
the static metadata plays the role of the template parameters and jit
retraces per static configuration).
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field treated as static (hashable) metadata under jit."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["pmg_static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def pytree_dataclass(cls):
    """Register a frozen dataclass as a JAX pytree.

    Fields declared with :func:`static_field` become aux metadata (must be
    hashable); everything else is a child (arrays / nested pytrees).
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("pmg_static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    return jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )
