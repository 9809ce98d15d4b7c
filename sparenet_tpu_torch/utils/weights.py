"""JAX-package weights -> the port's state_dict (counterpart of
sparenet_tpu/utils/torch_import.py: _to_torch, netG_rules, atlasnet_rules,
msn_rules and the export_*_state_dict functions).

``state_dict_from_jax(variables, model_type=...)`` takes the JAX package's
generator variables (SpareNetGenerator, AtlasNet or MSN) as a nested dict of
numpy arrays (``{"params": ..., "batch_stats": ...}``) and returns a
state_dict in the original reference's layout of that model, which the
port's model takes whole with ``load_state_dict(strict=True)``. The rule
tables are this module's own copies, SpareNet's for the ported
configuration (``use_adain="share"``, ``encode="Residualnet"``).

``reference_state_dict(model)`` goes the other way for the port's own
generators: the state_dict in that same reference layout (the port keeps
the per-primitive decoder weights stacked), which the port's checkpoints
hold.

``disc_state_dict_from_jax(params, batch_stats, spectral)`` does the same
for the JAX package's discriminator (``ProjectionD`` or
``PatchDiscriminator``) into the port's ``models.discriminator`` layout.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["netG_rules", "atlasnet_rules", "msn_rules", "state_dict_from_jax",
           "reference_state_dict", "disc_state_dict_from_jax"]

_DEC_BOTTLENECK = 1026


def _to_torch(kind: str, v: np.ndarray) -> np.ndarray:
    """flax Dense kernel [in, out] -> torch weight layouts."""
    if kind == "lin_w":
        return v.T
    if kind == "conv1d_w":
        return v.T[:, :, None]
    if kind == "conv2d_w":
        return v.T[:, :, None, None]
    return v  # "id"


class _Rules:
    """(collection, flax path, torch key template, kind, stacked) entries;
    ``{p}`` in a template is the primitive index."""

    def __init__(self):
        self.entries: list[tuple[str, tuple[str, ...], str, str, bool]] = []

    def add(self, col, fpath, tkey, kind, stacked=False):
        self.entries.append((col, tuple(fpath), tkey, kind, stacked))

    def dense(self, fpath, tkey, stacked=False, bias=True, kind="lin_w"):
        self.add("params", fpath + ("kernel",), tkey + ".weight", kind, stacked)
        if bias:
            self.add("params", fpath + ("bias",), tkey + ".bias", "id", stacked)

    def bn(self, fpath, tkey, stacked=False):
        self.add("params", fpath + ("scale",), tkey + ".weight", "id", stacked)
        self.add("params", fpath + ("bias",), tkey + ".bias", "id", stacked)
        self.add("batch_stats", fpath + ("mean",), tkey + ".running_mean",
                 "id", stacked)
        self.add("batch_stats", fpath + ("var",), tkey + ".running_var",
                 "id", stacked)

    def se(self, fpath, tkey, stacked=False):
        self.dense(fpath + ("Linear_0",), tkey + ".fc.0", stacked, bias=False)
        self.dense(fpath + ("Linear_1",), tkey + ".fc.2", stacked, bias=False)


def netG_rules(use_selayer: bool = True) -> _Rules:
    """The SpareNetGenerator key mapping (share / Residualnet)."""
    r = _Rules()
    f = ("encoder", "EdgeConvResFeat_0")
    t = "encoder.feat_extractor"
    for i in range(4):
        r.dense(f + (f"EdgeConv1x1_{i}",), f"{t}.conv{i + 1}", bias=False,
                kind="conv2d_w")
        r.bn(f + (f"BatchNorm_{i}",), f"{t}.bn{i + 1}")
        if use_selayer:
            r.se(f + (f"SELayer_{i}",), f"{t}.se{i + 1}")
    for i in range(3):
        r.dense(f + (f"Conv1d_{i}",), f"{t}.resconv{i + 1}", bias=False,
                kind="conv1d_w")
    r.dense(f + ("Conv1d_3",), f"{t}.conv5", bias=False, kind="conv1d_w")
    r.bn(f + ("BatchNorm_4",), f"{t}.bn5")
    r.dense(("encoder", "Linear_0"), "encoder.linear")
    r.bn(("encoder", "BatchNorm_0"), "encoder.bn")

    r.dense(("decoder", "Linear_0"), "decoder.mlp.0")
    r.dense(("decoder", "Linear_1"), "decoder.mlp.2")
    froot, troot = ("decoder", "VmapGridDecoder_0"), "decoder.decoder.{p}.dec"
    for i in range(4):
        r.dense(froot + (f"Conv1d_{i}",), f"{troot}.conv{i + 1}", True,
                kind="conv1d_w")
    for i in range(3):
        r.bn(froot + (f"BatchNorm_{i}",), f"{troot}.bn{i + 1}", True)
        if use_selayer:
            r.se(froot + (f"SELayer_{i}",), f"{troot}.se{i + 1}", True)

    _pointnet_res_rules(r, ("refine", "PointNetRes_0"), "refine.residual",
                        use_selayer)
    return r


def _pointnet_res_rules(r: _Rules, froot, troot, use_selayer: bool) -> None:
    """PointNetRes (its bn7 is registered but unused)."""
    for i in range(7):
        r.dense(froot + (f"Conv1d_{i}",), f"{troot}.conv{i + 1}",
                kind="conv1d_w")
    for i in range(6):
        r.bn(froot + (f"BatchNorm_{i}",), f"{troot}.bn{i + 1}")
    if use_selayer:
        for j, i in enumerate((1, 2, 4, 5, 6)):  # PointNetRes has no se3
            r.se(froot + (f"SELayer_{j}",), f"{troot}.se{i}")


def atlasnet_rules() -> _Rules:
    """AtlasNet: PointEncoder (PointNetfeat, hide 1024, no SE) and the
    PointGenCon decoders (the JAX package's vmap, one a primitive)."""
    r = _Rules()
    f, t = ("PointEncoder_0", "PointNetfeat_0"), "encoder.feat_extractor"
    for i in range(3):
        r.dense(f + (f"Conv1d_{i}",), f"{t}.conv{i + 1}", kind="conv1d_w")
        r.bn(f + (f"BatchNorm_{i}",), f"{t}.bn{i + 1}")
    r.dense(("PointEncoder_0", "Linear_0"), "encoder.linear")
    r.bn(("PointEncoder_0", "BatchNorm_0"), "encoder.bn")
    for i in range(4):
        r.dense(("VmapPointGenCon_0", f"Conv1d_{i}"), f"decoder.{{p}}.conv{i + 1}",
                True, kind="conv1d_w")
    for i in range(3):
        r.bn(("VmapPointGenCon_0", f"BatchNorm_{i}"), f"decoder.{{p}}.bn{i + 1}",
             True)
    return r


def msn_rules() -> _Rules:
    """MSN: AtlasNet's and the residual net under ``res`` (no SE)."""
    r = atlasnet_rules()
    _pointnet_res_rules(r, ("PointNetRes_0",), "res", use_selayer=False)
    return r


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


_SPARENET, _ATLASNET, _MSN = "SpareNet", "AtlasNet", "MSN"


def state_dict_from_jax(variables: dict[str, Any], *, use_selayer: bool = True,
                        n_primitives: int = 32,
                        model_type: str = _SPARENET) -> dict[str, torch.Tensor]:
    """JAX generator variables of ``model_type`` ("SpareNet", "AtlasNet" or
    "MSN"; ``use_selayer`` is SpareNet's) -> reference-layout state_dict of
    CPU float32 tensors, including the reference's registered-but-unused
    tensors at their defaults (every BatchNorm's num_batches_tracked; for
    SpareNet the top-level conv1, refine.residual.bn7 and the AdaIN dummy
    running stats; for MSN res.bn7)."""
    rules = {_SPARENET: lambda: netG_rules(use_selayer),
             _ATLASNET: atlasnet_rules, _MSN: msn_rules}
    if model_type not in rules:
        raise ValueError(f"state_dict_from_jax: no rules for {model_type!r}")
    sd: dict[str, np.ndarray] = {}
    bn_prefixes: list[str] = []
    for col, fpath, tkey, kind, stacked in rules[model_type]().entries:
        v = np.asarray(_get(variables[col], fpath), np.float32)
        if stacked:
            for p in range(n_primitives):
                sd[tkey.format(p=p)] = _to_torch(kind, v[p])
        else:
            sd[tkey] = _to_torch(kind, v)
        if tkey.endswith(".running_var"):
            bn_prefixes.append(tkey[: -len(".running_var")])

    def dummy_bn(prefix: str, nf: int, affine: bool = True):
        if affine:
            sd[f"{prefix}.weight"] = np.ones(nf, np.float32)
            sd[f"{prefix}.bias"] = np.zeros(nf, np.float32)
        sd[f"{prefix}.running_mean"] = np.zeros(nf, np.float32)
        sd[f"{prefix}.running_var"] = np.ones(nf, np.float32)

    if model_type == _MSN:
        dummy_bn("res.bn7", 3)
        bn_prefixes.append("res.bn7")
    if model_type == _SPARENET:
        sd["conv1.weight"] = np.zeros((64, 3, 1), np.float32)
        sd["conv1.bias"] = np.zeros(64, np.float32)
        dummy_bn("refine.residual.bn7", 3)
        bn_prefixes.append("refine.residual.bn7")
        b = _DEC_BOTTLENECK
        for p in range(n_primitives):
            for i, nf in enumerate((b, b // 2, b // 4)):
                dummy_bn(f"decoder.decoder.{p}.dec.adain{i + 1}", nf,
                         affine=False)
    for prefix in bn_prefixes:
        for key in {prefix.format(p=p) for p in range(n_primitives)}:
            sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def reference_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A generator's state_dict in the reference's layout, the layout
    ``state_dict_from_jax`` gives, as CPU tensors: each stacked decoder's
    [P, ...] tensors split into the reference's per-primitive keys, with its
    registered-but-unused tensors added at their defaults (its
    ``reference_state``: SpareNet's ``decoder.decoder.{p}.dec.<name>``,
    AtlasNet's and MSN's ``decoder.{p}.<name>``). ``load_state_dict`` stacks
    them back."""
    stacks = [(name + ".", m) for name, m in model.named_modules()
              if hasattr(m, "reference_state")]
    out: dict[str, torch.Tensor] = {}
    for key, v in model.state_dict().items():
        if not any(key.startswith(prefix) for prefix, _ in stacks):
            out[key] = v.detach().cpu().clone()
    for prefix, stack in stacks:
        out.update(stack.reference_state(prefix))
    return out


def _hwc_to_chw(v: np.ndarray, channels: int, axis: int) -> np.ndarray:
    """Reorder a flattened (H, W, C) axis of v into (C, H, W) order."""
    n = v.shape[axis]
    side = int(round((n // channels) ** 0.5))
    shape = v.shape[:axis] + (side, side, channels) + v.shape[axis + 1:]
    v = np.moveaxis(v.reshape(shape), axis + 2, axis)
    return v.reshape(v.shape[:axis] + (n,) + v.shape[axis + 3:])


def disc_state_dict_from_jax(params: dict, batch_stats: dict, spectral: dict,
                             *, use_cgan: bool = True) -> dict[str, torch.Tensor]:
    """JAX discriminator variables (numpy trees of its ``params``,
    ``batch_stats`` and ``spectral`` collections) -> the port's state_dict.
    Conv kernels (kh, kw, in, out) become [out, in, kh, kw]; the dense kernel
    [in, out] becomes [out, in] with its input axis, and the embedding table
    its feature axis, reordered from flax's (H, W, C) flattening to (C, H,
    W); BatchNorm scale/bias/mean/var go to weight/bias/running_*."""
    sd: dict[str, np.ndarray] = {}
    n_conv = 4 if use_cgan else 7
    for j in range(n_conv):
        name = f"conv{j + 1}" if j < n_conv - (0 if use_cgan else 1) else "adv"
        p = params[f"SNConv_{j}"]
        sd[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
        if "bias" in p:
            sd[f"{name}.bias"] = np.asarray(p["bias"])
        sd[f"{name}.u"] = np.asarray(spectral[f"SNConv_{j}"]["u"])
    for j in range(n_conv - (1 if use_cgan else 2)):
        name = f"bn{j + 2}"
        sd[f"{name}.weight"] = np.asarray(params[f"BatchNorm_{j}"]["scale"])
        sd[f"{name}.bias"] = np.asarray(params[f"BatchNorm_{j}"]["bias"])
        sd[f"{name}.running_mean"] = np.asarray(batch_stats[f"BatchNorm_{j}"]["mean"])
        sd[f"{name}.running_var"] = np.asarray(batch_stats[f"BatchNorm_{j}"]["var"])
        sd[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)
    if use_cgan:
        c = sd[f"conv{n_conv}.weight"].shape[0]
        kernel = np.asarray(params["SNDense_0"]["kernel"])
        sd["adv.weight"] = _hwc_to_chw(kernel, c, 0).T
        sd["adv.bias"] = np.asarray(params["SNDense_0"]["bias"])
        sd["adv.u"] = np.asarray(spectral["SNDense_0"]["u"])
        if "SNEmbed_0" in params:
            table = np.asarray(params["SNEmbed_0"]["embedding"])
            sd["embed.weight"] = _hwc_to_chw(table, c, 1)
            sd["embed.u"] = np.asarray(spectral["SNEmbed_0"]["u"])
    return {k: torch.from_numpy(np.array(v, dtype=v.dtype, order="C"))
            for k, v in sd.items()}
