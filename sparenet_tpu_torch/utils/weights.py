"""JAX-package weights -> the port's state_dict (counterpart of
sparenet_tpu/utils/torch_import.py: _flat_perm, _to_torch, netG_rules,
atlasnet_rules, msn_rules, grnet_rules and the export_*_state_dict
functions).

``state_dict_from_jax(variables, model_type=...)`` takes the JAX package's
generator variables (SpareNetGenerator, AtlasNet, MSN or GRNet) as a nested
dict of numpy arrays (``{"params": ..., "batch_stats": ...}``) and returns a
state_dict in the original reference's layout of that model, which the
port's model takes whole with ``load_state_dict(strict=True)``. The rule
tables are this module's own copies, SpareNet's for every configuration
(``use_adain`` "share", "no_share" or "no_use"; ``encode`` "Residualnet"
or "Pointfeat"), and two the JAX exporter lacks: EdgeRes
(``edgeres_rules``) and the SIREN GridDecoder (``sine_decoder_rules``),
under the reference's module names.

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

__all__ = ["netG_rules", "atlasnet_rules", "msn_rules", "grnet_rules",
           "edgeres_rules", "sine_decoder_rules", "state_dict_from_jax",
           "module_state_dict_from_jax", "reference_state_dict",
           "disc_state_dict_from_jax", "fpd_state_dict_from_jax"]

_DEC_BOTTLENECK = 1026
_GRNET_BOTTLENECK_CH = 256  # GRNet's conv4 output channels


def _flat_perm(n: int, c: int = _GRNET_BOTTLENECK_CH) -> np.ndarray:
    """GRNet's fc bottleneck flatten: for each flat index (x, y, z, c) of
    flax's channel-last [s, s, s, C] volume, the flat index (c, x, y, z) of
    the reference's channel-first flatten of the same volume."""
    s = round((n // c) ** (1.0 / 3.0))
    if c * s ** 3 != n:
        raise ValueError(f"bottleneck size {n} is not {c} * s^3")
    i = np.arange(n)
    x, r = divmod(i, s * s * c)
    y, r = divmod(r, s * c)
    z, cc = divmod(r, c)
    return ((cc * s + x) * s + y) * s + z


def _to_torch(kind: str, v: np.ndarray) -> np.ndarray:
    """flax kernels -> torch weight layouts: Dense [in, out]; Conv
    [kx, ky, kz, in, out] -> [out, in, kx, ky, kz]; ConvTranspose (padding
    "SAME") [kx, ky, kz, in, out] -> [in, out, kx, ky, kz] with its taps
    flipped in space; GRNet's fc5/fc6 with the channel-last flatten of the
    bottleneck reordered channel-first."""
    if kind == "lin_w":
        return v.T
    if kind == "conv1d_w":
        return v.T[:, :, None]
    if kind == "conv2d_w":
        return v.T[:, :, None, None]
    if kind == "conv3d_w":
        return v.transpose(4, 3, 0, 1, 2)
    if kind == "deconv3d_w":
        return v.transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1].copy()
    if kind == "fc_in_w":
        return v[np.argsort(_flat_perm(v.shape[0]))].T
    if kind == "fc_out_w":
        return v.T[np.argsort(_flat_perm(v.shape[1]))]
    if kind == "fc_out_b":
        return v[np.argsort(_flat_perm(v.shape[0]))]
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


def netG_rules(use_adain: str = "share", encode: str = "Residualnet",
               use_selayer: bool = True, edgeres: bool = False) -> _Rules:
    """The SpareNetGenerator key mapping of one configuration (the JAX
    exporter's table: both encoders, the three decoders), plus the EdgeRes
    refine (``edgeres``), which the JAX exporter has no rule for."""
    r = _Rules()
    t = "encoder.feat_extractor"
    if encode == "Residualnet":
        f = ("encoder", "EdgeConvResFeat_0")
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
    elif encode == "Pointfeat":
        f = ("encoder", "PointNetfeat_0")
        for i in range(3):
            r.dense(f + (f"Conv1d_{i}",), f"{t}.conv{i + 1}", kind="conv1d_w")
            r.bn(f + (f"BatchNorm_{i}",), f"{t}.bn{i + 1}")
        if use_selayer:
            for i in range(2):
                r.se(f + (f"SELayer_{i}",), f"{t}.se{i + 1}")
    else:
        raise ValueError(f"unknown encode {encode!r}")
    r.dense(("encoder", "Linear_0"), "encoder.linear")
    r.bn(("encoder", "BatchNorm_0"), "encoder.bn")

    if use_adain == "share":
        r.dense(("decoder", "Linear_0"), "decoder.mlp.0")
        r.dense(("decoder", "Linear_1"), "decoder.mlp.2")
        _grid_decoder_rules(r, ("decoder", "VmapGridDecoder_0"),
                            "decoder.decoder.{p}.dec", use_selayer)
    elif use_adain == "no_share":
        f = ("decoder", "Vmap_AdaInPointGenCon_0")
        r.dense(f + ("Linear_0",), "decoder.decoder.{p}.mlp.0", True)
        r.dense(f + ("Linear_1",), "decoder.decoder.{p}.mlp.2", True)
        _grid_decoder_rules(r, f + ("GridDecoder_0",),
                            "decoder.decoder.{p}.dec", use_selayer)
    elif use_adain == "no_use":
        _point_gen_con_rules(r, ("decoder", "VmapPointGenCon_0"),
                             "decoder.decoder.{p}", use_selayer)
    else:
        raise ValueError(f"unknown use_adain {use_adain!r}")

    if edgeres:
        edgeres_rules(("refine", "EdgeRes_0"), "refine.residual", use_selayer,
                      r)
    else:
        _pointnet_res_rules(r, ("refine", "PointNetRes_0"), "refine.residual",
                            use_selayer)
    return r


def _grid_decoder_rules(r: _Rules, froot, troot, use_selayer: bool) -> None:
    """GridDecoder (non-SIREN), stacked over the primitives."""
    for i in range(4):
        r.dense(froot + (f"Conv1d_{i}",), f"{troot}.conv{i + 1}", True,
                kind="conv1d_w")
    for i in range(3):
        r.bn(froot + (f"BatchNorm_{i}",), f"{troot}.bn{i + 1}", True)
        if use_selayer:
            r.se(froot + (f"SELayer_{i}",), f"{troot}.se{i + 1}", True)


def _point_gen_con_rules(r: _Rules, froot, troot, use_selayer: bool) -> None:
    """PointGenCon, stacked over the primitives."""
    for i in range(4):
        r.dense(froot + (f"Conv1d_{i}",), f"{troot}.conv{i + 1}", True,
                kind="conv1d_w")
    for i in range(3):
        r.bn(froot + (f"BatchNorm_{i}",), f"{troot}.bn{i + 1}", True)
        if use_selayer:
            r.se(froot + (f"SELayer_{i}",), f"{troot}.se{i + 1}", True)


def _prefix(troot: str) -> str:
    return troot + "." if troot else ""


def edgeres_rules(froot=("refine", "EdgeRes_0"),
                  troot: str = "refine.residual", use_selayer: bool = True,
                  r: _Rules | None = None) -> _Rules:
    """EdgeRes (no JAX exporter rule): the JAX module's Conv2d1x1_0-6,
    BatchNorm_0-5 and SELayer_0-4 as the reference's conv1-7 (1x1 Conv2d
    without bias), bn1-6 and se1, se2, se4, se5, se6 under ``troot``
    (added to ``r`` where given)."""
    r = _Rules() if r is None else r
    t = _prefix(troot)
    for i in range(7):
        r.dense(froot + (f"Conv2d1x1_{i}",), f"{t}conv{i + 1}", bias=False,
                kind="conv2d_w")
    for i in range(6):
        r.bn(froot + (f"BatchNorm_{i}",), f"{t}bn{i + 1}")
    if use_selayer:
        for j, i in enumerate((1, 2, 4, 5, 6)):
            r.se(froot + (f"SELayer_{j}",), f"{t}se{i}")
    return r


def sine_decoder_rules(froot=(), troot: str = "{p}.dec",
                       stacked: bool = False) -> _Rules:
    """The SIREN GridDecoder (no JAX exporter rule): the JAX module's
    Dense_0-3 as the reference's SineLayer products linear1-4.linear and
    Dense_4 as linear5 (1x1 Conv1d weights) under ``troot``; ``stacked``
    when the JAX parameters carry a leading primitive axis."""
    r = _Rules()
    t = _prefix(troot)
    for i in range(4):
        r.dense(froot + (f"Dense_{i}",), f"{t}linear{i + 1}.linear", stacked,
                kind="conv1d_w")
    r.dense(froot + ("Dense_4",), f"{t}linear5", stacked, kind="conv1d_w")
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
    _point_gen_con_rules(r, ("VmapPointGenCon_0",), "decoder.{p}", False)
    return r


def msn_rules() -> _Rules:
    """MSN: AtlasNet's and the residual net under ``res`` (no SE)."""
    r = atlasnet_rules()
    _pointnet_res_rules(r, ("PointNetRes_0",), "res", use_selayer=False)
    return r


def grnet_rules() -> _Rules:
    """GRNet: 4 Conv3d blocks, the fc5/fc6 bottleneck, 4 ConvTranspose3d
    blocks and the fc11-fc14 MLP. The voxel axes agree (x-major on both
    sides), so the conv kernels map by a transpose (the transposed ones
    also flipped); the bottleneck's weights absorb the flatten order."""
    r = _Rules()
    for i in range(4):
        r.dense((f"_ConvBlock_{i}", "Conv_0"), f"conv{i + 1}.0",
                kind="conv3d_w")
        r.bn((f"_ConvBlock_{i}", "BatchNorm_0"), f"conv{i + 1}.1")
    r.add("params", ("Linear_0", "kernel"), "fc5.0.weight", "fc_in_w")
    r.add("params", ("Linear_0", "bias"), "fc5.0.bias", "id")
    r.add("params", ("Linear_1", "kernel"), "fc6.0.weight", "fc_out_w")
    r.add("params", ("Linear_1", "bias"), "fc6.0.bias", "fc_out_b")
    for i in range(4):
        r.dense((f"_DeconvBlock_{i}", "ConvTranspose_0"), f"dconv{i + 7}.0",
                bias=False, kind="deconv3d_w")
        r.bn((f"_DeconvBlock_{i}", "BatchNorm_0"), f"dconv{i + 7}.1")
    for j, t in enumerate(("fc11.0", "fc12.0", "fc13.0", "fc14")):
        r.dense((f"Linear_{j + 2}",), t)
    return r


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


_SPARENET, _ATLASNET, _MSN, _GRNET = "SpareNet", "AtlasNet", "MSN", "GRNet"


def state_dict_from_jax(variables: dict[str, Any], *, use_selayer: bool = True,
                        n_primitives: int = 32, model_type: str = _SPARENET,
                        use_adain: str = "share", encode: str = "Residualnet",
                        edgeres: bool = False) -> dict[str, torch.Tensor]:
    """JAX generator variables of ``model_type`` ("SpareNet", "AtlasNet",
    "MSN" or "GRNet"; ``use_selayer``, ``use_adain``, ``encode`` and
    ``edgeres`` are SpareNet's) -> reference-layout state_dict of CPU
    float32 tensors, including the reference's registered-but-unused
    tensors at their defaults (every BatchNorm's num_batches_tracked; for
    SpareNet the top-level conv1, PointNetRes's bn7 and, for the AdaIN
    decoders, AdaIN's dummy running stats; for MSN res.bn7)."""
    rules = {_SPARENET: lambda: netG_rules(use_adain, encode, use_selayer,
                                           edgeres),
             _ATLASNET: atlasnet_rules, _MSN: msn_rules, _GRNET: grnet_rules}
    if model_type not in rules:
        raise ValueError(f"state_dict_from_jax: no rules for {model_type!r}")
    sd, bn_prefixes = _convert(variables, rules[model_type](), n_primitives)

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
        if not edgeres:
            dummy_bn("refine.residual.bn7", 3)
            bn_prefixes.append("refine.residual.bn7")
        b = _DEC_BOTTLENECK
        for p in range(n_primitives if use_adain != "no_use" else 0):
            for i, nf in enumerate((b, b // 2, b // 4)):
                dummy_bn(f"decoder.decoder.{p}.dec.adain{i + 1}", nf,
                         affine=False)
    return _finish(sd, bn_prefixes, n_primitives)


def _convert(variables: dict, rules: _Rules, n_primitives: int):
    """(state_dict of numpy arrays, the BatchNorm prefixes) by ``rules``."""
    sd: dict[str, np.ndarray] = {}
    bn_prefixes: list[str] = []
    for col, fpath, tkey, kind, stacked in rules.entries:
        v = np.asarray(_get(variables[col], fpath), np.float32)
        if stacked:
            for p in range(n_primitives):
                sd[tkey.format(p=p)] = _to_torch(kind, v[p])
        else:
            sd[tkey] = _to_torch(kind, v)
        if tkey.endswith(".running_var"):
            bn_prefixes.append(tkey[: -len(".running_var")])
    return sd, bn_prefixes


def _finish(sd: dict, bn_prefixes: list, n_primitives: int) -> dict:
    """Add each BatchNorm's zero step count; numpy -> CPU tensors."""
    for prefix in bn_prefixes:
        for key in {prefix.format(p=p) for p in range(n_primitives)}:
            sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def module_state_dict_from_jax(variables: dict[str, Any], rules: _Rules,
                               n_primitives: int = 1
                               ) -> dict[str, torch.Tensor]:
    """JAX module variables -> the port module's state_dict by ``rules``
    (``edgeres_rules((), "")`` for an ``EdgeRes``,
    ``sine_decoder_rules()`` for a SIREN ``GridDecoderStack`` of
    ``n_primitives``), with every BatchNorm's zero step count; a stack's
    AdaIN dummy statistics are its own to add (``reference_state``)."""
    sd, bn_prefixes = _convert(variables, rules, n_primitives)
    return _finish(sd, bn_prefixes, n_primitives)


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


def _fpd_layers():
    """(flax path, reference name, kind, BatchNorm name or None) of the FPD
    classifier's layers (the JAX package's load_torch_state, inverted)."""
    stn, feat = "PointNetFeat_0/STN3d_0", "PointNetFeat_0"
    out = []
    for i, (name, kind) in enumerate((("conv1", "conv1d_w"), ("conv2", "conv1d_w"),
                                      ("conv3", "conv1d_w"), ("fc1", "lin_w"),
                                      ("fc2", "lin_w"))):
        out.append((f"{stn}/Dense_{i}", f"feat.stn.{name}", kind,
                    (f"{stn}/BatchNorm_{i}", f"feat.stn.bn{i + 1}")))
    out.append((f"{stn}/Dense_5", "feat.stn.fc3", "lin_w", None))
    for i in range(3):
        out.append((f"{feat}/Dense_{i}", f"feat.conv{i + 1}", "conv1d_w",
                    (f"{feat}/BatchNorm_{i}", f"feat.bn{i + 1}")))
    for i in range(2):
        out.append((f"Dense_{i}", f"fc{i + 1}", "lin_w",
                    (f"BatchNorm_{i}", f"bn{i + 1}")))
    out.append(("Dense_2", "fc3", "lin_w", None))
    return out


def fpd_state_dict_from_jax(flat: dict[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's FPD classifier variables in its flax-flat npz
    layout (``params/PointNetFeat_0/STN3d_0/Dense_0/kernel``, ...,
    ``batch_stats/.../mean``; sparenet_tpu/data/fpd_cls_canonical.npz) -> a
    state_dict in the reference's Frechet/pointnet.py names, which
    ``frechet.PointNetCls`` loads with ``load_state_dict(strict=True)``:
    Conv1d weights [out, in, 1], Linear [out, in], every BatchNorm's
    weight, bias, running statistics and a zero step count."""
    sd: dict[str, np.ndarray] = {}
    for fpath, name, kind, bn in _fpd_layers():
        sd[f"{name}.weight"] = _to_torch(kind, np.asarray(flat[f"params/{fpath}/kernel"]))
        sd[f"{name}.bias"] = np.asarray(flat[f"params/{fpath}/bias"])
        if bn is not None:
            bpath, bname = bn
            sd[f"{bname}.weight"] = np.asarray(flat[f"params/{bpath}/scale"])
            sd[f"{bname}.bias"] = np.asarray(flat[f"params/{bpath}/bias"])
            sd[f"{bname}.running_mean"] = np.asarray(flat[f"batch_stats/{bpath}/mean"])
            sd[f"{bname}.running_var"] = np.asarray(flat[f"batch_stats/{bpath}/var"])
            sd[f"{bname}.num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}
