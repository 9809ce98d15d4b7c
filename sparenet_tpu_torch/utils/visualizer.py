"""Result tables, point-cloud plots and depth-map PNGs (the port's copy of
sparenet_tpu/utils/visualizer.py; reference: utils/visualizer.py:17-169).

``print_table`` writes the per-category table. ``get_ptcloud_img``,
``plot_pcd_three_views`` and ``tensorboard_save_image`` draw with
matplotlib and raise a RuntimeError naming it where it is not installed
(``require_matplotlib``). ``save_depth_map`` renders the partial, output and
ground-truth clouds of a batch from the 8 views at radius 7 with the port's
renderer (p2i #9 on the card: 24 launches with a ground truth) and writes
each first cloud's map with ``save_gray_png``: a PNG writer of the port's
own (zlib and struct) that reproduces ``plt.imsave(path, img, cmap="gray",
vmin=0, vmax=1)`` pixel for pixel: matplotlib's gray lookup table made in
bytes as it makes it (``(linspace(0, 1, 256) * 255).astype(uint8)``, which
rounds some levels down), its ``x * 256`` binning with 1.0 in the top bin,
its under, over and bad colours, as 8-bit RGBA. ``read_png`` reads such a
file back.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

__all__ = ["print_table", "require_matplotlib", "get_ptcloud_img",
           "plot_pcd_three_views", "tensorboard_save_image", "gray_rgba",
           "save_gray_png", "read_png", "save_depth_map", "DEPTH_RADIUS"]

# the radius of the depth maps the render mode writes
DEPTH_RADIUS = 7.0
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_LEVELS = 256
# matplotlib's gray colormap in bytes: 256 levels, then the under (the
# first level), over (the last) and bad (transparent black) colours
_GRAY = (np.linspace(0.0, 1.0, _LEVELS) * 255).astype(np.uint8)
_GRAY_LUT = np.concatenate([
    np.stack([_GRAY, _GRAY, _GRAY, np.full(_LEVELS, 255, np.uint8)], -1),
    [[_GRAY[0]] * 3 + [255], [_GRAY[-1]] * 3 + [255], [0, 0, 0, 0]],
]).astype(np.uint8)


def require_matplotlib(what: str):
    """``matplotlib.pyplot`` on the Agg backend, or a RuntimeError that
    names matplotlib and ``what`` needed it."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(f"{what} needs matplotlib, which is not "
                           f"installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def print_table(cfg, epoch_idx, test_metrics, category_metrics, test_writer,
                test_losses):
    """Per-category metric table + JSON line appended to DIR.logs/test.txt."""
    log_table = {"epoch": epoch_idx}
    print("============================ TEST RESULTS ============================")
    print("epoch", epoch_idx)
    header = ["Taxonomy", "#Sample"] + list(test_metrics.items)
    print("\t".join(header))
    for taxonomy_id, meter in category_metrics.items():
        row = [str(taxonomy_id), str(meter.count(0))]
        row += ["%.4f" % v for v in meter.avg()]
        print("\t".join(row))
        for i, m in enumerate(meter.items):
            log_table[f"{taxonomy_id}_{m}"] = "%.6f" % meter.avg(i)
    print("Overall\t\t" + "\t".join("%.4f" % v for v in test_metrics.avg()))
    print()
    for i, m in enumerate(test_metrics.items):
        log_table[f"overall_{m}"] = "%.6f" % test_metrics.avg(i)

    if test_writer is not None:
        if len(test_losses.items) >= 2:
            test_writer.add_scalar("Loss/Epoch/Sparse", test_losses.avg(0), epoch_idx)
            test_writer.add_scalar("Loss/Epoch/Dense", test_losses.avg(1), epoch_idx)
        for i, metric in enumerate(test_metrics.items):
            test_writer.add_scalar(f"Metric/{metric}", test_metrics.avg(i), epoch_idx)
    os.makedirs(cfg.DIR.logs, exist_ok=True)
    with open(os.path.join(cfg.DIR.logs, "test.txt"), "a") as f:
        f.write("json_stats: " + json.dumps(log_table) + "\n")


def get_ptcloud_img(ptcloud) -> np.ndarray:
    """Single 3D scatter rendered to an RGB array
    (utils/visualizer.py:17-42)."""
    plt = require_matplotlib("get_ptcloud_img")
    ptcloud = np.asarray(ptcloud)
    fig = plt.figure(figsize=(3, 3))
    x, z, y = ptcloud.transpose(1, 0)
    ax = fig.add_subplot(projection="3d")
    ax.axis("off")
    ax.view_init(30, -45)
    ax.set_xlim((-0.3, 0.3))
    ax.set_ylim((-0.3, 0.3))
    ax.set_zlim((-0.3, 0.3))
    ax.scatter(x, y, z, zdir="z", c=x, cmap="jet")
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def plot_pcd_three_views(filename, pcds, titles, suptitle="", sizes=None,
                         cmap="Reds", zdir="y",
                         xlim=(-0.3, 0.3), ylim=(-0.3, 0.3), zlim=(-0.3, 0.3)):
    """3 views x len(pcds) grid (utils/visualizer.py:45-76)."""
    plt = require_matplotlib("plot_pcd_three_views (TEST.mode 'vis')")
    pcds = [np.asarray(p) for p in pcds]
    if sizes is None:
        sizes = [0.5] * len(pcds)
    fig = plt.figure(figsize=(len(pcds) * 3, 9))
    elev = 30
    for i in range(3):
        azim = -45 + 90 * i
        for j, (pcd, size) in enumerate(zip(pcds, sizes)):
            ax = fig.add_subplot(3, len(pcds), i * len(pcds) + j + 1,
                                 projection="3d")
            ax.view_init(elev, azim)
            ax.scatter(pcd[:, 0], pcd[:, 1], pcd[:, 2], zdir=zdir,
                       c=pcd[:, 0], s=size, cmap=cmap, vmin=-1, vmax=0.5)
            ax.set_title(titles[j])
            ax.set_axis_off()
            ax.set_xlim(xlim)
            ax.set_ylim(ylim)
            ax.set_zlim(zlim)
    plt.subplots_adjust(left=0.05, right=0.95, bottom=0.05, top=0.9,
                        wspace=0.1, hspace=0.1)
    plt.suptitle(suptitle)
    fig.savefig(filename)
    plt.close(fig)


def tensorboard_save_image(refine_ptcloud, data, test_writer, model_idx,
                           epoch_idx):
    """TB image triplet of a batch's first cloud (utils/visualizer.py:
    125-140)."""
    partial = np.asarray(data["partial_cloud"])[0]
    test_writer.add_image(
        "Model%02d/ParticalReconstruction" % model_idx,
        np.transpose(get_ptcloud_img(partial), (2, 0, 1)), 0)
    refine = np.asarray(refine_ptcloud)[0]
    test_writer.add_image(
        "Model%02d/DenseReconstruction" % model_idx,
        np.transpose(get_ptcloud_img(refine), (2, 0, 1)), epoch_idx)
    gt = np.asarray(data["gtcloud"])[0]
    test_writer.add_image(
        "Model%02d/GroundTruth" % model_idx,
        np.transpose(get_ptcloud_img(gt), (2, 0, 1)), 1)


def gray_rgba(img) -> np.ndarray:
    """[H, W] values -> [H, W, 4] uint8, as matplotlib's gray colormap maps
    them at vmin 0 and vmax 1 (normalising by those is exact)."""
    xa = np.array(img, dtype=np.result_type(np.asarray(img).dtype, np.float32))
    xa *= _LEVELS
    xa[xa == _LEVELS] = _LEVELS - 1
    under, over, bad = xa < 0, xa >= _LEVELS, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = _LEVELS
    idx[over] = _LEVELS + 1
    idx[bad] = _LEVELS + 2
    return _GRAY_LUT.take(idx, axis=0, mode="clip")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def save_gray_png(path: str, img) -> None:
    """``img`` [H, W] as an 8-bit RGBA PNG, pixel for pixel what
    ``plt.imsave(path, img, cmap="gray", vmin=0.0, vmax=1.0)`` writes
    (the JAX package's ``_save_gray_png``); the directory is made."""
    rgba = gray_rgba(img)
    h, w = rgba.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),      # filter 0
                           rgba.reshape(h, w * 4)], 1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """[H, W, 4] uint8 of an 8-bit RGBA PNG whose rows are all unfiltered
    (as ``save_gray_png`` writes them); raises ValueError otherwise."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    off, idat, head = 8, [], None
    while off < len(buf):
        (n,) = struct.unpack_from(">I", buf, off)
        kind, body = buf[off + 4:off + 8], buf[off + 8:off + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        off += 12 + n
    if head is None or head[2:] != (8, 6, 0, 0, 0):
        raise ValueError(f"{path}: header {head}; this reader takes 8-bit "
                         f"RGBA, not interlaced")
    w, h = head[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 4 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows; this reader takes "
                         f"unfiltered ones")
    return rows[:, 1:].reshape(h, w, 4).copy()


def save_depth_map(cfg, refine_ptcloud, data: dict, taxonomy_id,
                   model_idx) -> list:
    """Depth-map PNGs of a batch's first partial, output and (where the
    batch has one) ground-truth cloud from the 8 views at radius 7
    (utils/visualizer.py:143-169): DIR.logs/plots/<taxonomy>/<model_idx>/
    <view><1|2|3>.png. The clouds are tensors [B, N, 3] on one device, each
    rendered whole (depth is normalised over the batch, as in the JAX
    package); the paths written, in order."""
    from ..renderer import ComputeDepthMaps

    renderer = ComputeDepthMaps(
        projection=cfg.RENDER.projection,
        eyepos_scale=cfg.RENDER.eyepos,
        image_size=cfg.RENDER.img_size,
    )
    base = os.path.join(cfg.DIR.logs, "plots", str(taxonomy_id), str(model_idx))
    clouds = [("1", data["partial_cloud"]), ("2", refine_ptcloud)]
    if "gtcloud" in data:
        clouds.append(("3", data["gtcloud"]))
    paths = []
    for j in range(renderer.num_views):
        for tag, cloud in clouds:
            img = renderer(cloud, view_id=j, radius_list=[DEPTH_RADIUS])
            paths.append(os.path.join(base, f"{j}{tag}.png"))
            save_gray_png(paths[-1], img[0, :, :, 0].cpu().numpy())
    return paths
