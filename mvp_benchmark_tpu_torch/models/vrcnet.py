"""VRCNet completion model (port of ``mvp_benchmark_tpu/models/vrcnet.py``).

Reference: ``completion/models/vrcnet.py`` -- PCN encoder -> posterior net
(``Linear_ResBlock`` :95-105) -> latent z -> ``MSAP_SKN_decoder`` (:299-409)
with point self-attention (``SA_module`` :21-57), selective-kernel attention
(``SK_SA_module`` :108-155), a 4-level edge pool/unpool pyramid
(``SA_SKN_Res_encoder`` :179-296), FPS + learned-score top-k selection
(:380-393) and local folding (:60-92).

All three branches are ported. ``EFExpansion``, which the protocol config
never reaches (``up_scale == 1`` and ``local_folding`` on), comes with a
later slice and raises.

The noise is an argument. The JAX model draws ``z = q_mu + q_std * N(0, 1)``
from its ``sample`` RNG even in val and test (:517-518), and in train the two
latents ``z_q``, ``z_p`` (:507-510), the two dropout keep-masks of the
encoder's global feature (:223-225; p = 0.5) and, for the MMD loss, four more
normals (:540-546). The port takes them from the caller: the standard-normal
``eps`` (B, size_z) in eval, and in train a dict ``noise`` whose names and
shapes ``Model.noise_shapes`` lists in the order the JAX model draws them
(``draw_noise`` draws them from a generator). So a caller
(``train/engine.py``) can give a card run, a CPU run and the JAX model the
same numbers.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mvp_benchmark_tpu_torch import ops
from mvp_benchmark_tpu_torch.metrics import calc_cd, calc_emd
from mvp_benchmark_tpu_torch.models import common, layers
from mvp_benchmark_tpu_torch.models.pcn import PCNEncoder
from mvp_benchmark_tpu_torch.train.config import parse_int_list


def _ef_expansion_missing(why: str) -> NotImplementedError:
    return NotImplementedError(
        f"VRCNet with {why} needs EFExpansion, which is not ported yet")


class LinearResBlock(nn.Module):
    """FC residual block (vrcnet.py:31-41 of the JAX package)."""

    def __init__(self, input_size: int, output_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.fc1 = layers.TorchDense(input_size, input_size, generator=g)
        self.fc2 = layers.TorchDense(input_size, output_size, generator=g)
        self.fc3 = layers.TorchDense(input_size, output_size, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.fc1(torch.relu(x)))
        return self.fc2(h) + self.fc3(x)


class SAModule(nn.Module):
    """Point self-attention over fixed kNN groups (vrcnet.py:44-111):
    x (B, N, C), idx (B, N, k) -> (B, N, out_planes), with C == out_planes.

    The three heads (x1 rel, proj rel, proj mid) run as one MultiDense; the
    gather, the w-MLP and the weighted sum are one ``ops.sa_attention``
    (the CUDA kernel on the card). ``w_mlp1``, ``w_mlp2`` and
    ``w_mlp2_bias`` are raw parameters in the flax (in, out) orientation:
    they enter the block as ``w_in @ W1``, not as a Linear.
    """

    def __init__(self, rel_planes: int, mid_planes: int, out_planes: int,
                 share_planes: int, k: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.rel, self.mid, self.share = rel_planes, mid_planes, share_planes
        ms = mid_planes // share_planes
        self.proj = layers.MultiDense(out_planes, (rel_planes, rel_planes,
                                                   mid_planes), generator=g)
        self.w_mlp1 = nn.Parameter(torch.empty((1 + k) * rel_planes, ms))
        self.w_mlp2 = nn.Parameter(torch.empty(ms, k * ms))
        self.w_mlp2_bias = nn.Parameter(torch.empty(k * ms))
        for p, fan_in in ((self.w_mlp1, (1 + k) * rel_planes),
                          (self.w_mlp2, ms), (self.w_mlp2_bias, ms)):
            layers._uniform_(p, fan_in, g)
        self.out = layers.TorchDense(mid_planes, out_planes, generator=g)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        rel = self.rel
        y = self.proj(torch.relu(x))                     # (B, N, 2rel+mid)
        out = ops.sa_attention(y[..., rel:], y[..., :rel], idx, self.w_mlp1,
                               self.w_mlp2, self.w_mlp2_bias, rel, self.mid,
                               self.share)
        return self.out(torch.relu(out)) + x


class SKSAModule(nn.Module):
    """Selective-kernel attention over SA branches, one per k
    (vrcnet.py:114-144), with the JAX module's r = 2 and L = 32."""

    def __init__(self, rel_planes: int, mid_planes: int, out_planes: int,
                 share_planes: int, k: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        d = max(out_planes // 2, 32)
        self.branches = nn.ModuleList(
            SAModule(rel_planes, mid_planes, out_planes, share_planes, ki,
                     generator=g) for ki in k)
        self.fc_z = layers.TorchDense(out_planes, d, generator=g)
        self.fcs = nn.ModuleList(layers.TorchDense(d, out_planes, generator=g)
                                 for _ in k)

    def forward(self, x: torch.Tensor, idxs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(idxs) != len(self.branches):
            raise ValueError(f"{len(idxs)} neighbour tables for "
                             f"{len(self.branches)} branches")
        feas = torch.stack([torch.relu(sa(x, idx))
                            for sa, idx in zip(self.branches, idxs)], dim=1)
        fea_s = feas.sum(dim=1).mean(dim=1)                 # (B, C)
        fea_z = self.fc_z(fea_s)
        vectors = torch.stack([fc(fea_z) for fc in self.fcs], dim=1)
        attn = torch.softmax(vectors, dim=1)[:, :, None, :]
        return torch.sum(feas * attn, dim=1)


class SKNResUnit(nn.Module):
    """SK-SA residual unit (vrcnet.py:147-163)."""

    def __init__(self, in_features: int, output_size: int, k: Sequence[int],
                 layers_n: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.fc_in = layers.TorchDense(in_features, output_size, bias=False,
                                       generator=g)
        self.blocks = nn.ModuleList(
            SKSAModule(output_size // 16, output_size // 4, output_size, 8, k,
                       generator=g) for _ in range(layers_n))
        self.fc_out = layers.TorchDense(output_size, output_size, bias=False,
                                        generator=g)
        self.fc_skip = layers.TorchDense(in_features, output_size, bias=False,
                                         generator=g)

    def forward(self, feat: torch.Tensor, idxs) -> torch.Tensor:
        x = self.fc_in(feat)
        for block in self.blocks:
            x = block(x, idxs)
        return self.fc_out(torch.relu(x)) + self.fc_skip(feat)


DROPOUT_RATE = 0.5      # SASKNResEncoder.dropout_rate of the JAX package


def _dropout(x: torch.Tensor, keep: Optional[torch.Tensor]) -> torch.Tensor:
    """flax ``nn.Dropout`` with the keep-mask given: kept entries scaled by
    1 / (1 - rate), the others 0; the identity without a mask."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - DROPOUT_RATE), torch.zeros_like(x))


class SASKNResEncoder(nn.Module):
    """4-level SK-SA pyramid with edge pool/unpool (vrcnet.py:166-244):
    features (B, N, C_in), xyz in the first 3 channels -> (B, N, output_size).
    """

    def __init__(self, in_features: int, k: Sequence[int], pk: int,
                 output_size: int, layers_cfg: Sequence[int],
                 pts_num: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.k = tuple(int(ki) for ki in k)
        self.pk = int(pk)
        self.pts_num = tuple(int(p) for p in pts_num)
        c1 = 64
        widths = (in_features, 2 * c1, 4 * c1, 8 * c1)   # edge pooling doubles
        self.units = nn.ModuleList(
            SKNResUnit(w, c1 * 2 ** i, self.k, layers_cfg[i], generator=g)
            for i, w in enumerate(widths))
        self.gf1 = layers.TorchDense(8 * c1, 1024, generator=g)
        self.gf2 = layers.TorchDense(1024, 512, generator=g)
        self.gf3 = layers.TorchDense(512, 1024, generator=g)
        self.up4 = layers.DenseCat((1024, 8 * c1), 8 * c1, generator=g)
        self.up3 = layers.TorchDense(8 * c1 + 4 * c1, 4 * c1, generator=g)
        self.up2 = layers.TorchDense(4 * c1 + 2 * c1, 2 * c1, generator=g)
        self.up1 = layers.TorchDense(2 * c1 + c1, c1, generator=g)
        self.out = layers.TorchDense(c1, output_size, generator=g)

    def _knn_idxs(self, pts):
        return [ops.knn_indices(pts, ki) for ki in self.k]

    def _eps_idx(self, idxs):
        """The widest self-kNN branch, whose rows edge_preserve_sampling
        reuses when it holds at least pk neighbours (vrcnet.py:182-188)."""
        widest = max(range(len(self.k)), key=lambda i: self.k[i])
        return idxs[widest] if self.k[widest] >= self.pk else None

    def forward(self, features: torch.Tensor,
                keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``keep``: the two dropout keep-masks (B, 512) and (B, 1024) of the
        global feature in train, None (no dropout) in eval."""
        relu = torch.relu
        pts = [features[..., 0:3]]
        skips = []
        x = features
        for level, unit in enumerate(self.units):
            idxs = self._knn_idxs(pts[-1])
            x = relu(unit(x, idxs))
            skips.append(x)
            if level < 3:
                x, _, _, p = common.edge_preserve_sampling(
                    x, pts[-1], self.pts_num[level + 1], self.pk,
                    knn_idx=self._eps_idx(idxs))
                pts.append(p)

        x1, x2, x3, x4 = skips
        gf = torch.amax(self.gf1(x4), dim=1)
        keep = (None, None) if keep is None else keep
        gf = _dropout(relu(self.gf2(gf)), keep[0])
        gf = _dropout(relu(self.gf3(gf)), keep[1])
        # virtual concat [tile(global), x4] (layers.DenseCat)
        x = relu(self.up4(gf[:, None, :], x4))
        for up, skip, fine, coarse in ((self.up3, x3, pts[2], pts[3]),
                                       (self.up2, x2, pts[1], pts[2]),
                                       (self.up1, x1, pts[0], pts[1])):
            idx, w = ops.three_nn_upsampling(fine, coarse)
            x = ops.three_interpolate(x, idx, w)
            x = relu(up(torch.cat([x, skip], dim=-1)))
        return self.out(x)


class Folding(nn.Module):
    """Local folding upsampler (vrcnet.py:247-278): point_feat (B, N, C),
    global_feat (B, G) -> (B, N * step_ratio, output_size)."""

    def __init__(self, global_size: int, point_size: int, output_size: int,
                 step_ratio: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.step_ratio = int(step_ratio)
        # rows ordered [global, point, grid 2]
        self.fold = layers.DenseCat((global_size, point_size, 2), output_size,
                                    generator=generator)

    def forward(self, point_feat: torch.Tensor,
                global_feat: torch.Tensor) -> torch.Tensor:
        B, N, _ = point_feat.shape
        sr = self.step_ratio
        pf = torch.repeat_interleave(point_feat, sr, dim=1)      # (B, N*sr, C)
        grid = layers.gen_grid_up(sr, 0.2, device=point_feat.device)
        grid_feat = grid.repeat(N, 1)[None].expand(B, N * sr, 2)
        return torch.relu(self.fold(global_feat[:, None, :], pf, grid_feat))


class MSAPSKNDecoder(nn.Module):
    """Multi-scale attentive decoder (vrcnet.py:281-386). The point counts
    of every stage follow from the config, so the modules of the stages the
    config reaches (FPS, score top-k, folding) are built here."""

    def __init__(self, num_coarse_raw: int, num_fps: int, num_coarse: int,
                 num_fine: int, num_input: int, layers_cfg: Sequence[int],
                 knn_list: Sequence[int], pk: int, points_label: bool,
                 local_folding: bool, global_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        dense, expand = 256, 64
        self.num_coarse_raw = num_coarse_raw
        self.num_fps = num_fps
        self.num_coarse = num_coarse
        self.num_fine = num_fine
        self.num_input = num_input
        self.points_label = points_label
        if int(math.ceil(num_fine / (num_coarse_raw + 2048))) >= 2:
            raise _ef_expansion_missing(f"num_points {num_fine} > "
                                        f"num_coarse_raw + 2048")
        self.fc1 = layers.TorchDense(global_size, 1024, generator=g)
        self.fc2 = layers.TorchDense(1024, 1024, generator=g)
        self.fc3 = layers.TorchDense(1024, num_coarse_raw * 3,
                                     dtype=torch.float32, generator=g)
        n_total = num_coarse_raw + num_input
        self.encoder = SASKNResEncoder(
            4 if points_label else 3, knn_list, pk, dense, layers_cfg,
            (n_total, n_total // 2, n_total // 4, n_total // 8), generator=g)
        self.fc4 = layers.TorchDense(dense, expand, generator=g)
        self.fc5 = layers.TorchDense(expand, 3, dtype=torch.float32, generator=g)

        n_fps = min(n_total, num_fps)
        self.top_k = n_fps > num_coarse
        if self.top_k:
            self.score1 = layers.TorchDense(expand, 16, generator=g)
            self.score2 = layers.TorchDense(16, 8, generator=g)
            self.score3 = layers.TorchDense(8, 1, generator=g)
        n_coarse = num_coarse if self.top_k else n_fps
        self.step_ratio = 0
        if n_coarse < num_fine:
            if not local_folding:
                raise _ef_expansion_missing("local_folding off")
            self.step_ratio = num_fine // num_coarse
            self.folding = Folding(global_size, expand, dense, self.step_ratio,
                                   generator=g)
            self.fine_out = layers.TorchDense(expand, 3, dtype=torch.float32,
                                              generator=g)
            self.fine_mid = layers.TorchDense(dense, expand, generator=g)
        elif n_coarse != num_fine:
            raise ValueError(f"{n_coarse} coarse points for num_points {num_fine}")

    def forward(self, global_feat: torch.Tensor, point_input: torch.Tensor,
                keep: Optional[Sequence[torch.Tensor]] = None):
        B = global_feat.shape[0]
        if point_input.shape[1] != self.num_input:
            raise ValueError(f"built for {self.num_input} input points, got "
                             f"{point_input.shape[1]}")
        h = torch.relu(self.fc1(global_feat))
        h = torch.relu(self.fc2(h))
        coarse_raw = self.fc3(h).reshape(B, self.num_coarse_raw, 3)

        coarse_input, org_input = coarse_raw, point_input
        if self.points_label:
            coarse_input = F.pad(coarse_raw, (0, 1), value=0.0)
            org_input = F.pad(point_input, (0, 1), value=1.0)
        points = torch.cat([coarse_input, org_input], dim=1)
        dense_feat = self.encoder(points, keep)

        coarse_features = torch.relu(self.fc4(dense_feat))
        coarse_high = self.fc5(coarse_features)

        coarse = coarse_high
        if coarse_high.shape[1] > self.num_fps:
            idx_fps = ops.furthest_point_sample(coarse_high, self.num_fps)
            coarse = ops.gather_points(coarse_high, idx_fps)
            coarse_features = ops.gather_points(coarse_features, idx_fps)

        if self.top_k:
            scores = self.score1(coarse_features)
            scores = self.score2(torch.relu(scores))
            scores = self.score3(torch.relu(scores))
            scores = F.softplus(scores).squeeze(-1)
            # lax.top_k's order: descending, ties to the lower index
            idx = torch.sort(scores, dim=1, descending=True, stable=True)[1]
            idx = idx[:, :self.num_coarse].to(torch.int32)
            coarse = ops.gather_points(coarse, idx)
            coarse_features = ops.gather_points(coarse_features, idx)

        fine = coarse
        if self.step_ratio:
            up_features = self.folding(coarse_features, global_feat)
            center = torch.repeat_interleave(coarse, self.step_ratio, dim=1)
            fine = self.fine_out(torch.relu(self.fine_mid(up_features))) + center
        return coarse_raw, coarse_high, coarse, fine


def build(args, generator: Optional[torch.Generator] = None) -> "Model":
    return Model(
        num_points=int(args.num_points),
        layers_cfg=tuple(parse_int_list(args.layers or "2,2,2,2")),
        knn_list=tuple(parse_int_list(args.knn_list or "10,20")),
        pk=int(args.pk or 10),
        points_label=bool(args.points_label),
        local_folding=bool(args.local_folding),
        num_coarse_raw=int(args.num_coarse_raw or 1024),
        num_fps=int(args.num_fps or 2048),
        num_coarse=int(args.num_coarse or 2048),
        distribution_loss=str(args.distribution_loss or "KLD"),
        train_loss=str(args.loss or "cd"),
        eval_emd=bool(args.eval_emd),
        generator=generator,
    )


def _kl_normal(mu1, std1, mu2, std2):
    """KL(N(mu1, std1) || N(mu2, std2)), elementwise (vrcnet.py:389-395)."""
    return (torch.log(std2 / std1)
            + (std1 ** 2 + (mu1 - mu2) ** 2) / (2.0 * std2 ** 2) - 0.5)


def _mmd_kernel(x, y):
    """k[i, j] = exp(-mean((x_i - y_j)^2) / dim) (vrcnet.py:398-403)."""
    sq = torch.mean((x[:, None, :] - y[None, :, :]) ** 2, dim=2)
    return torch.exp(-sq / float(x.shape[1]))


def mmd_loss(x, y):
    """Kernel MMD between two batches of latents (vrcnet.py:406-412)."""
    return (torch.mean(_mmd_kernel(x, x)) + torch.mean(_mmd_kernel(y, y))
            - 2.0 * torch.mean(_mmd_kernel(x, y)))


class Model(nn.Module):
    """VRCNet. forward(x (B, N, 3), gt, prefix, alpha, eps, noise) like the
    reference Model (vrcnet.py:412-527), with the noise given by the caller:
    ``eps`` (B, size_z) in val and test, ``noise`` (``noise_shapes``) in
    train. The JAX model's size_z 128 and global feature size 1024, which no
    config sets, are constants here."""

    size_z = 128

    def __init__(self, num_points: int = 2048,
                 layers_cfg: Sequence[int] = (1, 1, 1, 1),
                 knn_list: Sequence[int] = (16,), pk: int = 10,
                 points_label: bool = True, local_folding: bool = True,
                 num_coarse_raw: int = 1024, num_fps: int = 2048,
                 num_coarse: int = 2048, distribution_loss: str = "KLD",
                 train_loss: str = "cd", eval_emd: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        gfs, size_z = 1024, self.size_z
        self.num_points = num_points
        self.distribution_loss = distribution_loss
        self.train_loss = train_loss
        self.eval_emd = eval_emd
        self.encoder = PCNEncoder(gfs, generator=g)
        self.posterior_infer1 = LinearResBlock(gfs, gfs, generator=g)
        self.posterior_infer2 = LinearResBlock(gfs, 2 * size_z, generator=g)
        self.generator = LinearResBlock(size_z, gfs, generator=g)
        self.decoder = MSAPSKNDecoder(
            num_coarse_raw, num_fps, num_coarse, num_points, num_points,
            layers_cfg, knn_list, pk, points_label, local_folding, gfs,
            generator=g)
        # the prior net, which only the train branch runs; built last, so the
        # weights a seed gives the eval modules do not depend on it
        self.prior_infer = LinearResBlock(gfs, 2 * size_z, generator=g)

    def noise_shapes(self, batch_size: int) -> Dict[str, tuple]:
        """The noise of one train step for a batch of ``batch_size`` clouds,
        {name: shape}, in the order the JAX model draws it: the standard
        normals of z_q and z_p, the encoder's two dropout keep-masks (bool),
        and MMD's four standard normals."""
        B, z = batch_size, self.size_z
        shapes = {"z_q": (B, z), "z_p": (B, z),
                  "keep1": (2 * B, 512), "keep2": (2 * B, 1024)}
        if self.distribution_loss == "MMD":
            shapes.update({n: (B, z) for n in ("z_m", "z_q2", "z_p2", "z_p_fix")})
        return shapes

    def draw_noise(self, batch_size: int,
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One train step's noise, drawn on the CPU from ``generator``: keep
        masks True with probability 1 - DROPOUT_RATE."""
        out = {}
        for name, shape in self.noise_shapes(batch_size).items():
            if name.startswith("keep"):
                out[name] = torch.rand(shape, generator=generator) < 1.0 - DROPOUT_RATE
            else:
                out[name] = torch.randn(shape, generator=generator)
        return out

    def _check_noise(self, noise, batch_size: int) -> None:
        want = self.noise_shapes(batch_size)
        got = None if noise is None else {n: tuple(t.shape) for n, t in noise.items()}
        if got != want:
            raise ValueError(f"VRCNet's train step takes its noise as an "
                             f"argument: pass noise with shapes {want}, got {got}")

    def forward(self, x: torch.Tensor, gt: Optional[torch.Tensor] = None,
                prefix: str = "train", alpha=None,
                eps: Optional[torch.Tensor] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None):
        if prefix == "train":
            t = self.train_losses(x, gt, 1.0 if alpha is None else alpha, noise)
            return t["fine"], t["loss4"], t["total"]
        if eps is None or tuple(eps.shape) != (x.shape[0], self.size_z):
            raise ValueError(
                f"VRCNet samples z = q_mu + q_std * eps: pass eps, standard "
                f"normal of shape {(x.shape[0], self.size_z)}, got "
                f"{None if eps is None else tuple(eps.shape)}")
        feat = self.encoder(x)
        o_x = self.posterior_infer2(self.posterior_infer1(feat))
        q_mu, q_std = torch.split(o_x, self.size_z, dim=1)
        z = q_mu + F.softplus(q_std) * eps
        feat = feat + self.generator(z)
        coarse_raw, _, _, fine = self.decoder(feat, x)
        if prefix == "val":
            if self.eval_emd:
                emd = calc_emd(fine, gt, eps=0.004, iterations=3000)
            else:
                emd = torch.zeros(fine.shape[0], device=fine.device)
            cd_p, cd_t, f1 = calc_cd(fine, gt, calc_f1=True)
            return {"out1": coarse_raw, "out2": fine, "emd": emd,
                    "cd_p": cd_p, "cd_t": cd_t, "f1": f1}
        return {"result": fine}

    def train_losses(self, x: torch.Tensor, gt: torch.Tensor, alpha: float,
                     noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The dual path and the loss (vrcnet.py:474-570 of the JAX package)
        -> {"fine", "loss1".."loss4" (per cloud of the doubled batch),
        "dl_rec", "dl_g" (elementwise), "total"}."""
        if self.distribution_loss not in ("KLD", "MMD"):
            raise NotImplementedError(
                "Distribution loss is either MMD or KLD "
                "(reference vrcnet.py:495-504).")
        if self.train_loss != "cd":
            raise NotImplementedError("Only CD is supported")
        B, num_input = x.shape[0], x.shape[1]
        self._check_noise(noise, B)
        # Reconstruction on gt resampled to num_input points + completion on
        # x; fps(gt, N) with N == |gt| selects every point, and the encoder
        # and the CD losses do not see the order, so y = gt then.
        if num_input == gt.shape[1]:
            y = gt
        else:
            y = ops.gather_points(gt, ops.furthest_point_sample(gt, num_input))
        feat = self.encoder(torch.cat([x, y], dim=0))
        feat_x, feat_y = feat[:B], feat[B:]
        o_x = self.posterior_infer2(self.posterior_infer1(feat_x))
        q_mu, q_std = torch.split(o_x, self.size_z, dim=1)
        p_mu, p_std = torch.split(self.prior_infer(feat_y), self.size_z, dim=1)
        q_std, p_std = F.softplus(q_std), F.softplus(p_std)
        z_q = q_mu + q_std * noise["z_q"]
        z_p = p_mu + p_std * noise["z_p"]
        feat = torch.cat([feat_x, feat_x], dim=0)
        feat = feat + self.generator(torch.cat([z_q, z_p], dim=0))
        coarse_raw, coarse_high, coarse, fine = self.decoder(
            feat, torch.cat([x, x], dim=0), keep=(noise["keep1"], noise["keep2"]))

        if self.distribution_loss == "KLD":
            # dl_rec = KL(N(0, 1) || p); dl_g = KL(p detached || q)
            dl_rec = _kl_normal(torch.zeros_like(p_mu), torch.ones_like(p_std),
                                p_mu, p_std)
            dl_g = _kl_normal(p_mu.detach(), p_std.detach(), q_mu, q_std)
        else:
            z_q2 = q_mu + q_std * noise["z_q2"]
            z_p2 = p_mu + p_std * noise["z_p2"]
            z_p_fix = p_mu.detach() + p_std.detach() * noise["z_p_fix"]
            dl_rec = mmd_loss(noise["z_m"], z_p2)
            dl_g = mmd_loss(z_q2, z_p_fix)

        gt2 = torch.cat([gt, gt], dim=0)
        loss1, _ = calc_cd(coarse_raw, gt2)
        loss2, _ = calc_cd(coarse_high, gt2)
        loss3, _ = calc_cd(coarse, gt2)
        loss4, _ = calc_cd(fine, gt2)
        total = (loss1.mean() * 10.0 + loss2.mean() * 0.5
                 + loss3.mean() + loss4.mean() * alpha)
        total = total + (dl_rec.mean() + dl_g.mean()) * 20.0
        return {"fine": fine, "loss1": loss1, "loss2": loss2, "loss3": loss3,
                "loss4": loss4, "dl_rec": dl_rec, "dl_g": dl_g, "total": total}
