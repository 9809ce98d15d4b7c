"""Train a PointNet classifier to back the FPD metric (counterpart of
sparenet_tpu/frechet/train_classifier.py).

The reference's pretrained classifier is missing upstream; this trains a
k-way replacement on ground-truth clouds of any of the port's datasets, as
the JAX package does: Adam at ``lr`` with optax's defaults (b1 0.9, b2
0.999, eps 1e-8), softmax cross-entropy plus 1e-3 times the STN
orthogonality term mean_b |T T^T - I|^2, BatchNorm in train mode as flax
(batch statistics, the running variance stored biased:
``models.layers.bn_apply``), and the JAX package's draws from one
``np.random.RandomState(seed)``: each epoch's permutation of the items, then
each item's point subsample, in that order. Full batches only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models import resolve_device, set_parity_mode
from .pointnet import PointNetCls

__all__ = ["train_classifier", "orthogonality"]


def orthogonality(trans: torch.Tensor) -> torch.Tensor:
    """mean over the batch of sum((T T^T - I)^2) for trans [B, 3, 3]."""
    eye = torch.eye(3, dtype=trans.dtype, device=trans.device)
    return ((torch.bmm(trans, trans.transpose(1, 2)) - eye) ** 2).sum(
        (1, 2)).mean()


def train_classifier(dataset, num_classes: int = 16, n_points: int = 1024,
                     epochs: int = 10, batch_size: int = 32,
                     lr: float = 1e-3, seed: int = 0, logger=None,
                     init_state: dict | None = None, device=None
                     ) -> PointNetCls:
    """dataset: indexable of (taxonomy_id, label, model_id, data) items with
    data["gtcloud"]. Returns the trained ``PointNetCls`` in eval mode on
    ``device`` (None: the card). ``init_state`` (a state_dict in the
    reference's names) gives the starting weights; without it they are
    drawn from ``torch.Generator().manual_seed(seed)``: kernels
    lecun-normal (std 1/sqrt(fan_in), flax's Dense default), biases 0,
    BatchNorm scale 1 and bias 0."""
    set_parity_mode()
    dev = resolve_device(device)
    model = PointNetCls(k=num_classes)
    if init_state is not None:
        model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                               for k, v in init_state.items()}, strict=True)
    else:
        _lecun_init(model, torch.Generator().manual_seed(seed))
    model = model.to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    n = len(dataset)
    rs = np.random.RandomState(seed)
    for epoch in range(epochs):
        order = rs.permutation(n)
        tot_loss = tot_acc = nb = 0
        for s in range(0, n - batch_size + 1, batch_size):
            pcs, labels = [], []
            for i in order[s:s + batch_size]:
                _, label, _, data = dataset[int(i)]
                gt = data["gtcloud"]
                pcs.append(gt[rs.permutation(gt.shape[0])[:n_points]])
                labels.append(label)
            pc = torch.as_tensor(np.stack(pcs), dtype=torch.float32).to(dev)
            y = torch.as_tensor(np.asarray(labels), dtype=torch.long).to(dev)
            logits, trans, _ = model(pc)
            loss = F.cross_entropy(logits, y) + 1e-3 * orthogonality(trans)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot_loss += float(loss.detach())
            tot_acc += float((logits.argmax(-1) == y).float().mean())
            nb += 1
        if logger:
            logger.info("FPD classifier epoch %d: loss=%.4f acc=%.3f"
                        % (epoch, tot_loss / max(nb, 1), tot_acc / max(nb, 1)))
    return model.eval()


@torch.no_grad()
def _lecun_init(model: PointNetCls, generator: torch.Generator) -> None:
    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv1d, torch.nn.Linear)):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, torch.nn.BatchNorm1d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
