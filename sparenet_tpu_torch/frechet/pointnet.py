"""PointNet classifier for Frechet Pointcloud Distance activations
(counterpart of sparenet_tpu/frechet/pointnet.py).

Channel-last: clouds [B, N, 3]. ``PointNetCls(k)`` returns (logits [B, k],
trans [B, 3, 3], actv [B, 1808]), actv = concat(x1 [1024], x2 [512],
x3 [256], logits [k]). The logits are plain, as the JAX package returns them
(the reference's log-softmax over dim 0 feeds nothing of the FPD).

Module and parameter names are the reference's Frechet/pointnet.py
(``feat.stn.conv1-3``, ``feat.stn.fc1-3``, ``feat.stn.bn1-5``,
``feat.conv1-3``, ``feat.bn1-3``, ``fc1-3``, ``bn1-2``), so the reference's
``cls_model_39.pth`` loads with ``load_state_dict(strict=True)``. The 1x1
convolutions run as ``F.linear`` over the channel axis; BatchNorm follows
the JAX package (flax) in both modes (``models.layers.bn_apply``: batch
statistics over every axis but the channel, the running variance biased).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import bn_apply, conv1x1

__all__ = ["STN3d", "PointNetFeat", "PointNetCls", "load_torch_state",
           "ACTIVATION_DIMS"]

ACTIVATION_DIMS = 1024 + 512 + 256  # plus the k logits: 1808 at k = 16


class STN3d(nn.Module):
    """Spatial transformer predicting a 3x3 alignment: x [B, N, 3] ->
    [B, 3, 3] (the identity plus fc3's output)."""

    def __init__(self):
        super().__init__()
        for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 1024)), 1):
            setattr(self, f"conv{i}", nn.Conv1d(cin, cout, 1))
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, 9)
        for i, c in enumerate((64, 128, 1024, 512, 256), 1):
            setattr(self, f"bn{i}", nn.BatchNorm1d(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in (1, 2, 3):
            x = F.relu(bn_apply(getattr(self, f"bn{i}"),
                                conv1x1(getattr(self, f"conv{i}"), x)))
        h = x.amax(1)
        h = F.relu(bn_apply(self.bn4, self.fc1(h)))
        h = F.relu(bn_apply(self.bn5, self.fc2(h)))
        h = self.fc3(h)
        iden = torch.eye(3, dtype=h.dtype, device=h.device).reshape(9)
        return (h + iden).reshape(-1, 3, 3)


class PointNetFeat(nn.Module):
    """The global 1024-d feature after the STN transform: x [B, N, 3] ->
    (feature [B, 1024], trans [B, 3, 3])."""

    def __init__(self):
        super().__init__()
        self.stn = STN3d()
        for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 1024)), 1):
            setattr(self, f"conv{i}", nn.Conv1d(cin, cout, 1))
            setattr(self, f"bn{i}", nn.BatchNorm1d(cout))

    def forward(self, x: torch.Tensor):
        trans = self.stn(x)
        x = torch.bmm(x, trans)
        x = F.relu(bn_apply(self.bn1, conv1x1(self.conv1, x)))
        x = F.relu(bn_apply(self.bn2, conv1x1(self.conv2, x)))
        x = bn_apply(self.bn3, conv1x1(self.conv3, x))
        return x.amax(1), trans


class PointNetCls(nn.Module):
    """The classifier: x [B, N, 3] -> (logits [B, k], trans [B, 3, 3],
    actv [B, 1792 + k])."""

    def __init__(self, k: int = 16):
        super().__init__()
        self.k = k
        self.feat = PointNetFeat()
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k)
        self.bn1 = nn.BatchNorm1d(512)
        self.bn2 = nn.BatchNorm1d(256)

    def forward(self, x: torch.Tensor):
        x1, trans = self.feat(x)
        x2 = F.relu(bn_apply(self.bn1, self.fc1(x1)))
        x3 = F.relu(bn_apply(self.bn2, self.fc2(x2)))
        x4 = self.fc3(x3)
        return x4, trans, torch.cat([x1, x2, x3, x4], dim=1)


def load_torch_state(state_dict: dict, k: int = 16) -> PointNetCls:
    """A ``PointNetCls`` on the CPU in eval mode holding a reference
    cls_model state_dict (tensors or numpy arrays), loaded strictly: the
    names are the module's own, so nothing is converted."""
    model = PointNetCls(k=k)
    model.load_state_dict({name: torch.as_tensor(v) for name, v in
                           state_dict.items()}, strict=True)
    return model.eval()
