"""Reader of the JAX package's compact checkpoint archive (the port's copy of
sparenet_tpu/utils/ckpt_npz.py:load_npz).

The archive is one compressed npz whose keys are "bf16:" or "raw:" followed
by the leaf's path in the {"params", "batch_stats"} tree, joined with
``_SEP``; bf16 leaves are float32 stored as uint16, the upper half of the
f32 bits. ``load_npz`` restores the nested tree of float32 (and verbatim
raw) numpy leaves, which ``utils.weights.state_dict_from_jax`` turns into
the port's state_dict. Writing archives stays with the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["_SEP", "load_npz"]

_SEP = "//"


def load_npz(path: str) -> dict:
    """Restore an archive into {"params": ..., "batch_stats": ...}
    (f32 leaves, host numpy)."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            tag, rest = key.split(":", 1)
            leaf = data[key]
            if tag == "bf16":
                leaf = (leaf.astype(np.uint32) << np.uint32(16)).view(np.float32)
            elif tag != "raw":
                raise ValueError(f"{path}: unknown leaf tag {tag!r} in {key!r}")
            node = root
            parts = rest.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf
    return root
