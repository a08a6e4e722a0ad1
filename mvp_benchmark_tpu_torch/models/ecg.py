"""ECG completion model (port of ``mvp_benchmark_tpu/models/ecg.py``).

Reference: ``completion/models/ecg.py`` -- PCN encoder + edge-aware dense
graph-conv hierarchical encoder-decoder (``EF_encoder`` with DGCNN
``Dense_conv`` blocks :36-65, FPS downsampling via ``edge_preserve_sampling``
and ``three_interpolate`` upsampling :68-159). The ``val`` and ``test``
branches are ported; the ``train`` branch (uniform loss) comes with the
training slice, and ``EFExpansion``, which the protocol config never reaches
(``scale == 1``), with a later slice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from mvp_benchmark_tpu_torch import ops
from mvp_benchmark_tpu_torch.metrics import calc_cd, calc_emd
from mvp_benchmark_tpu_torch.models import common, layers
from mvp_benchmark_tpu_torch.models.pcn import PCNEncoder


class DenseConv(nn.Module):
    """DGCNN dense-graph-conv block (ecg.py:24-65): (B, N, C) ->
    (B, N, C + growth_rate * dense_n).

    Feature-space kNN, a project-then-gather DenseEdge over
    ``[x_i, x_j - x_i]``, and a densely connected stack of DenseCats over the
    running list of parts; max over neighbours commutes with the channel
    concatenation, so the parts are max-pooled first and concatenated after.
    """

    def __init__(self, in_features: int, growth_rate: int = 64,
                 dense_n: int = 3, k: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.k = k
        self.edge = layers.DenseEdge(in_features, growth_rate, "center_minus",
                                     generator=g)
        widths = [growth_rate, in_features]
        self.convs = nn.ModuleList()
        for _ in range(dense_n - 1):
            self.convs.append(layers.DenseCat(tuple(widths), growth_rate,
                                              generator=g))
            widths.append(growth_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idx = ops.knn_indices(x, self.k)
        e = torch.relu(self.edge(x, idx))
        parts = [e, x[:, :, None, :]]                  # centre broadcasts over k
        for i, conv in enumerate(self.convs):
            y = conv(*parts)
            if i != len(self.convs) - 1:
                y = torch.relu(y)
            parts.append(y)
        pooled = [p[:, :, 0, :] if p.shape[2] == 1 else torch.amax(p, dim=2)
                  for p in parts]
        return torch.cat(pooled, dim=-1)


class EFEncoder(nn.Module):
    """Hierarchical edge-feature encoder-decoder (ecg.py:68-128): points
    (B, N, 3) -> per-point features (B, N, output_size)."""

    def __init__(self, growth_rate: int = 24, dense_n: int = 3, k: int = 16,
                 hierarchy: Sequence[int] = (1024, 256, 64),
                 output_size: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.k = k
        self.hierarchy = tuple(int(h) for h in hierarchy)
        comp = growth_rate * 2
        grown = growth_rate * dense_n                       # DenseConv's growth
        c1 = 24 + grown + 24                                # 120
        c2 = comp + grown + 2 * c1                          # 360
        c3 = comp + grown + 2 * c2                          # 840
        c4 = comp + grown + 2 * c3                          # 1800
        self.lift = layers.TorchDense(3, 24, generator=g)
        self.conv1 = DenseConv(24, growth_rate, dense_n, k, generator=g)
        self.down2 = layers.TorchDense(2 * c1, comp, generator=g)
        self.conv2 = DenseConv(comp, growth_rate, dense_n, k, generator=g)
        self.down3 = layers.TorchDense(2 * c2, comp, generator=g)
        self.conv3 = DenseConv(comp, growth_rate, dense_n, k, generator=g)
        self.down4 = layers.TorchDense(2 * c3, comp, generator=g)
        self.conv4 = DenseConv(comp, growth_rate, dense_n, k, generator=g)
        self.gf1 = layers.TorchDense(c4, 1024, generator=g)
        self.gf2 = layers.TorchDense(1024, 512, generator=g)
        self.gf3 = layers.TorchDense(512, 1024, generator=g)
        self.up4 = layers.DenseCat((1024, c4), 1024, generator=g)
        self.up3 = layers.DenseCat((c3, 1024), 768, generator=g)
        self.up2 = layers.DenseCat((c2, 768), 512, generator=g)
        self.out = layers.DenseCat((c1, 512), output_size, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        relu = torch.relu
        pc1 = x[..., 0:3]
        h1, h2, h3 = self.hierarchy

        x0 = relu(self.lift(x))
        x1 = torch.cat([relu(self.conv1(x0)), x0], dim=-1)              # 120
        x1d, _, _, pc2 = common.edge_preserve_sampling(x1, pc1, h1, self.k)

        x2 = relu(self.down2(x1d))
        x2 = torch.cat([relu(self.conv2(x2)), x1d], dim=-1)             # 360
        x2d, _, _, pc3 = common.edge_preserve_sampling(x2, pc2, h2, self.k)

        x3 = relu(self.down3(x2d))
        x3 = torch.cat([relu(self.conv3(x3)), x2d], dim=-1)             # 840
        x3d, _, _, pc4 = common.edge_preserve_sampling(x3, pc3, h3, self.k)

        x4 = relu(self.down4(x3d))
        x4 = torch.cat([relu(self.conv4(x4)), x3d], dim=-1)             # 1800

        gf = torch.amax(self.gf1(x4), dim=1)
        gf = relu(self.gf2(gf))
        gf = relu(self.gf3(gf))

        # virtual concat [tile(gf), x4] (layers.DenseCat)
        x4 = relu(self.up4(gf[:, None, :], x4))
        idx, w = ops.three_nn_upsampling(pc3, pc4)
        x4 = ops.three_interpolate(x4, idx, w)

        x3 = relu(self.up3(x3, x4))
        idx, w = ops.three_nn_upsampling(pc2, pc3)
        x3 = ops.three_interpolate(x3, idx, w)

        x2 = relu(self.up2(x2, x3))
        idx, w = ops.three_nn_upsampling(pc1, pc2)
        x2 = ops.three_interpolate(x2, idx, w)

        return self.out(x1, x2)


class ECGDecoder(nn.Module):
    """FC coarse + EF refinement decoder (ecg.py:131-166)."""

    def __init__(self, num_coarse: int, num_fine: int, num_input: int,
                 hierarchy: Sequence[int] = (1024, 256, 64),
                 feat_size: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_coarse = num_coarse
        self.num_fine = num_fine
        self.scale = int(math.ceil(num_fine / (num_coarse + num_input)))
        if self.scale >= 2:
            raise NotImplementedError(
                f"ECG with num_points {num_fine} > num_coarse + num_input "
                f"({num_coarse + num_input}) needs EFExpansion, which is not "
                "ported yet")
        self.fc1 = layers.TorchDense(feat_size, 1024, generator=g)
        self.fc2 = layers.TorchDense(1024, 1024, generator=g)
        self.fc3 = layers.TorchDense(1024, num_coarse * 3, dtype=torch.float32,
                                     generator=g)
        self.ef = EFEncoder(growth_rate=24, dense_n=3, k=16,
                            hierarchy=hierarchy, output_size=256, generator=g)
        self.fc4 = layers.TorchDense(256, 64, generator=g)
        self.fc5 = layers.TorchDense(64, 3, dtype=torch.float32, generator=g)

    def forward(self, global_feat: torch.Tensor, point_input: torch.Tensor):
        B = global_feat.shape[0]
        h = torch.relu(self.fc1(global_feat))
        h = torch.relu(self.fc2(h))
        coarse = self.fc3(h).reshape(B, self.num_coarse, 3)

        points = torch.cat([coarse, point_input], dim=1)
        dense_feat = self.ef(points)
        feat = torch.relu(self.fc4(dense_feat))
        fine = self.fc5(feat)

        if fine.shape[1] > self.num_fine:
            fps_idx = ops.furthest_point_sample(fine, self.num_fine)
            fine = ops.gather_points(fine, fps_idx)
        return coarse, fine


def build(args, generator: Optional[torch.Generator] = None) -> "Model":
    num_points = int(args.num_points)
    # The reference hierarchy (1024, 256, 64) assumes 3072 encoder points
    # (1024 coarse + 2048 input); scale it for other sizes (ecg.py:169-182).
    scale = num_points / 2048.0
    hierarchy = tuple(max(int(h * scale), 8) for h in (1024, 256, 64))
    return Model(
        num_points=num_points,
        num_coarse=max(int(1024 * scale), 16),
        num_input=num_points,
        hierarchy=hierarchy,
        train_loss=str(args.loss or "cd"),
        eval_emd=bool(args.eval_emd),
        generator=generator,
    )


class Model(nn.Module):
    """ECG. forward(x (B, N, 3), gt, prefix) like the reference Model
    (ecg.py:185-229)."""

    def __init__(self, num_points: int = 2048, num_coarse: int = 1024,
                 num_input: int = 2048,
                 hierarchy: Sequence[int] = (1024, 256, 64),
                 train_loss: str = "cd", eval_emd: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_points = num_points
        self.train_loss = train_loss
        self.eval_emd = eval_emd
        self.encoder = PCNEncoder(generator=generator)
        self.decoder = ECGDecoder(num_coarse, num_points, num_input, hierarchy,
                                  generator=generator)

    def forward(self, x: torch.Tensor, gt: Optional[torch.Tensor] = None,
                prefix: str = "train", alpha=None):
        if prefix == "train":
            raise NotImplementedError(
                "ECG's train branch comes with the training slice")
        feat = self.encoder(x)
        out1, out2 = self.decoder(feat, x)
        if prefix == "val":
            if self.eval_emd:
                emd = calc_emd(out2, gt, eps=0.004, iterations=3000)
            else:
                emd = torch.zeros(out2.shape[0], device=out2.device)
            cd_p, cd_t, f1 = calc_cd(out2, gt, calc_f1=True)
            return {"out1": out1, "out2": out2, "emd": emd,
                    "cd_p": cd_p, "cd_t": cd_t, "f1": f1}
        return {"result": out2}
