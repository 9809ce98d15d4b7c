"""Result tables (the port's copy of sparenet_tpu/utils/visualizer.py:
print_table; reference: utils/visualizer.py:79-122).

The three-view plots, TensorBoard images and depth-map PNGs are not ported
yet (ROADMAP.md, queue 1 item 3).
"""

from __future__ import annotations

import json
import os

__all__ = ["print_table"]


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
