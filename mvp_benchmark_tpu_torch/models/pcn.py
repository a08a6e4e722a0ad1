"""PCN completion model (port of ``mvp_benchmark_tpu/models/pcn.py``).

Reference: ``completion/models/pcn.py`` -- PointNet-style encoder with two
max-pools (:13-30), FC coarse decoder + folding-grid upsampling (:33-71).
All three branches are ported. The ``train`` branch takes the CD or the EMD
loss; EMD needs as many points as gt (``calc_emd`` raises ValueError at
n != m, as the JAX package's does, so at the protocol's 1024 coarse points
against 2048 gt points it raises).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mvp_benchmark_tpu_torch.metrics import calc_cd, calc_emd
from mvp_benchmark_tpu_torch.models import layers


class PCNEncoder(nn.Module):
    """(B, N, 3) -> (B, output_size) global feature (pcn.py:13-30)."""

    def __init__(self, output_size: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.fc1 = layers.TorchDense(3, 128, generator=g)
        self.fc2 = layers.TorchDense(128, 256, generator=g)
        self.fc3 = layers.DenseCat((256, 256), 512, generator=g)
        self.fc4 = layers.TorchDense(512, output_size, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.fc1(x))
        h = self.fc2(h)
        g = torch.amax(h, dim=1, keepdim=True)                 # (B, 1, 256)
        # concat([h, tile(g)]) @ W as sliced matmuls (layers.DenseCat)
        h = torch.relu(self.fc3(h, g))
        h = self.fc4(h)
        return torch.amax(h, dim=1)                            # (B, out)


class PCNDecoder(nn.Module):
    """FC coarse + folding fine decoder (pcn.py:33-71)."""

    def __init__(self, num_coarse: int, num_fine: int, scale: int,
                 feat_size: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_coarse = num_coarse
        self.num_fine = num_fine
        self.scale = scale
        self.fc1 = layers.TorchDense(feat_size, 1024, generator=g)
        self.fc2 = layers.TorchDense(1024, 1024, generator=g)
        self.fc3 = layers.TorchDense(1024, num_coarse * 3,
                                     dtype=torch.float32, generator=g)
        # rows ordered [grid 2, point 3, global feat_size]
        self.fold1 = layers.DenseCat((2, 3, feat_size), 512, generator=g)
        self.fold2 = layers.TorchDense(512, 512, generator=g)
        self.fold3 = layers.TorchDense(512, 3, dtype=torch.float32,
                                       generator=g)

    def forward(self, feat: torch.Tensor):
        B = feat.shape[0]
        h = torch.relu(self.fc1(feat))
        h = torch.relu(self.fc2(h))
        coarse = self.fc3(h).reshape(B, self.num_coarse, 3)

        grid = layers.gen_grid_up(2 ** int(math.log2(self.scale)), 0.05,
                                  device=feat.device)
        grid_feat = grid.repeat(self.num_coarse, 1)             # (fine, 2)
        grid_feat = grid_feat[None].expand(B, self.num_fine, 2)

        point_feat = torch.repeat_interleave(coarse, self.scale, dim=1)
        # virtual concat [grid, point, tile(global)]: the global feature is
        # multiplied once per cloud, not once per point
        h = torch.relu(self.fold1(grid_feat, point_feat, feat[:, None, :]))
        h = torch.relu(self.fold2(h))
        fine = self.fold3(h) + point_feat
        return coarse, fine


def build(args, generator: Optional[torch.Generator] = None) -> "Model":
    return Model(
        num_points=int(args.num_points),
        num_coarse=int(args.num_coarse or 1024),
        train_loss=str(args.loss or "cd"),
        eval_emd=bool(args.eval_emd),
        generator=generator,
    )


class Model(nn.Module):
    """PCN. forward(x (B,N,3), gt, prefix) like the reference Model
    (pcn.py:74-114)."""

    def __init__(self, num_points: int = 2048, num_coarse: int = 1024,
                 train_loss: str = "cd", eval_emd: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_points = num_points
        self.num_coarse = num_coarse
        self.train_loss = train_loss
        self.eval_emd = eval_emd
        scale = num_points // num_coarse
        self.encoder = PCNEncoder(generator=generator)
        self.decoder = PCNDecoder(num_coarse, num_points, scale,
                                  generator=generator)

    def forward(self, x: torch.Tensor, gt: Optional[torch.Tensor] = None,
                prefix: str = "train", alpha=None):
        feat = self.encoder(x)
        out1, out2 = self.decoder(feat)
        if prefix == "train":                  # pcn.py:92-103 of the JAX package
            if self.train_loss == "emd":
                loss1 = calc_emd(out1, gt)
                loss2 = calc_emd(out2, gt)
            elif self.train_loss == "cd":
                loss1, _ = calc_cd(out1, gt)
                loss2, _ = calc_cd(out2, gt)
            else:
                raise NotImplementedError("Train loss is either CD or EMD!")
            total = loss1.mean() + loss2.mean() * (1.0 if alpha is None else alpha)
            return out2, loss2, total
        if prefix == "val":
            if self.eval_emd:
                emd = calc_emd(out2, gt, eps=0.004, iterations=3000)
            else:
                emd = torch.zeros(out2.shape[0], device=out2.device)
            cd_p, cd_t, f1 = calc_cd(out2, gt, calc_f1=True)
            return {"out1": out1, "out2": out2, "emd": emd,
                    "cd_p": cd_p, "cd_t": cd_t, "f1": f1}
        return {"result": out2}
