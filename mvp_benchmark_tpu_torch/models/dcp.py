"""DCP-v2 registration model (port of ``mvp_benchmark_tpu/models/dcp.py``).

Reference: ``registration/models/dcp.py`` -- DGCNN embedding (:269-301),
transformer pointer (:304-328, the annotated-transformer encoder/decoder
stack :69-243), softmax soft correspondence + weighted SVD head (:331-381),
loss ``mse(T_12 @ T_gt^-1, I)`` (:420-430).

On the card the path runs hand-written kernels: the self-kNN (k 20) and the
neighbour gather of DGCNN, its fused per-edge chain (``ops.edge_mlp_eval``;
in train ``ops.edge_mlp_train``: stat passes, final pass and backward
passes), the transformer's six multi-head attentions a batch
(``ops.attention_bnhd``, bf16) and the svd head's soft correspondence
(``ops.attention``, fp32), each attention with its backward in train.

As in the JAX package, the transformer's sublayers compute in bf16
(``TRANSFORMER_BF16``) and its residual stream is stored in bf16
(``TRANSFORMER_RESID_BF16``); both flags are read at every forward. The TPU
casts the svd head's embeddings to bf16 to fit VMEM (``dcp.py:300-304``);
the port keeps them fp32, which is what the JAX package's CPU path computes.

The train branch (``prefix="train"``) uses batch statistics in DGCNN's edge
chain and in its BatchNorm and moves their running statistics as flax's
mutable ``batch_stats`` do: one DGCNN serves src and then tgt, so a step
moves them twice, in that order. DCP draws no noise and has no dropout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mvp_benchmark_tpu_torch import metrics, ops
from mvp_benchmark_tpu_torch.models import layers

# Scoped bf16 for the transformer pointer (LayerNorm-based, no BatchNorm):
# LN statistics stay fp32, sublayer activations bf16; and a bf16 residual
# stream. The JAX package's defaults (dcp.py:329-337).
TRANSFORMER_BF16 = True
TRANSFORMER_RESID_BF16 = True

KNN_K = 20

# The key projections' biases: a bias added to every key moves every score of
# a row alike, which the softmax ignores, so their exact gradient is 0 and
# any computed one is rounding noise. Gradient checks hold them to the whole
# gradient's norm.
SHIFT_INVARIANT = ("self_attn.proj.bias1", "src_attn.proj.bias0")


class DGCNN(nn.Module):
    """Edge-conv embedding, (B, N, 3) -> (B, N, emb) (JAX ``DGCNN``).

    The edge tensor [x_j | x_i] over the 20 nearest neighbours is built from
    the gather kernel's rows, in bf16, (B, N, k, 6); the four Dense -> BN ->
    relu blocks and their max-pools over k run as one fused chain, with the
    running statistics in eval and the batch's in train (which then move
    the running ones, momentum 0.1, as ``dcp.py:92-99``). Its
    parameters keep the flax names and orientation: ``fused_W{i}`` (in, out),
    ``fused_scale{i}``/``fused_bias{i}``, and the running statistics
    ``fused_mean{i}``/``fused_var{i}`` as buffers.
    """

    def __init__(self, emb_dims: int = 512, fused_chs=(64, 64, 128, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fused_chs = tuple(fused_chs)
        cins = (6,) + self.fused_chs[:-1]
        for i, (cin, ch) in enumerate(zip(cins, self.fused_chs)):
            w = nn.Parameter(torch.empty(cin, ch))
            layers._uniform_(w, cin, generator)
            setattr(self, f"fused_W{i}", w)
            setattr(self, f"fused_scale{i}", nn.Parameter(torch.ones(ch)))
            setattr(self, f"fused_bias{i}", nn.Parameter(torch.zeros(ch)))
            self.register_buffer(f"fused_mean{i}", torch.zeros(ch))
            self.register_buffer(f"fused_var{i}", torch.ones(ch))
        self.fc = layers.TorchDense(sum(self.fused_chs), emb_dims, bias=False,
                                    generator=generator)
        self.bn = layers.BatchNorm(emb_dims)

    def _per_layer(self, name: str):
        return tuple(getattr(self, f"{name}{i}") for i in range(len(self.fused_chs)))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        idx = ops.knn_indices(x, KNN_K)                          # (B, N, k)
        neigh = ops.gather_points(x, idx)                        # (B, N, k, 3)
        a1 = torch.cat([neigh, x[:, :, None, :].expand_as(neigh)],
                       dim=-1).to(torch.bfloat16)
        chain = (self._per_layer("fused_W"), self._per_layer("fused_scale"),
                 self._per_layer("fused_bias"))
        if train:
            xs, stats = ops.edge_mlp_train(a1, *chain)
            for st, m, v in zip(stats, self._per_layer("fused_mean"),
                                self._per_layer("fused_var")):
                layers.update_running_stats(m, v, st[0], st[1])
        else:
            xs = ops.edge_mlp_eval(a1, *chain, self._per_layer("fused_mean"),
                                   self._per_layer("fused_var"))
        h = self.fc(torch.cat(xs, dim=-1))
        return torch.relu(self.bn(h, train))


class MultiHeadedAttention(nn.Module):
    """h-head attention with shared projections (reference dcp.py:198-229).

    ``shared``: which operands share one input and so one fused projection,
    "qkv" (self-attention: ``proj`` = MultiDense(d, d, d)) or "kv"
    (cross-attention: ``q`` = TorchDense, ``proj`` = MultiDense(d, d)). The
    heads are views (B, N, h, d_k) of the projection's rows, which the
    attention kernel reads in place.
    """

    def __init__(self, h: int, d_model: int, shared: str = "qkv",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if shared not in ("qkv", "kv"):
            raise ValueError(f"shared must be 'qkv' or 'kv', got {shared!r}")
        self.h, self.d_model, self.shared = h, d_model, shared
        g, d = generator, d_model
        if shared == "qkv":
            self.proj = layers.MultiDense(d, (d, d, d), dtype=dtype, generator=g)
        else:
            self.q = layers.TorchDense(d, d, dtype=dtype, generator=g)
            self.proj = layers.MultiDense(d, (d, d), dtype=dtype, generator=g)
        self.out = layers.TorchDense(d, d, dtype=dtype, generator=g)

    def forward(self, query: torch.Tensor,
                memory: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, d = query.shape[0], self.d_model

        def heads(y):
            return y.reshape(B, -1, self.h, d // self.h)

        if self.shared == "qkv":
            y = self.proj(query)
            q, k, v = heads(y[..., :d]), heads(y[..., d:2 * d]), heads(y[..., 2 * d:])
        else:
            q = heads(self.q(query))
            y = self.proj(memory)
            k, v = heads(y[..., :d]), heads(y[..., d:])
        x = layers.mha_attention_bnhd(q, k, v)
        return self.out(x.reshape(B, -1, d))


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = layers.TorchDense(d_model, d_ff, dtype=dtype, generator=generator)
        self.fc2 = layers.TorchDense(d_ff, d_model, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class EncoderLayer(nn.Module):
    """Pre-norm self-attention and feed-forward; ``rdt`` stores the residual
    stream (None keeps the caller's dtype)."""

    def __init__(self, d_model: int, d_ff: int, n_heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.rdt: Optional[torch.dtype] = None
        self.norm0 = layers.UnbiasedLayerNorm(d_model)
        self.self_attn = MultiHeadedAttention(n_heads, d_model, "qkv", generator=g)
        self.norm1 = layers.UnbiasedLayerNorm(d_model)
        self.ff = FeedForward(d_model, d_ff, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rdt is not None:
            x = x.to(self.rdt)
        x = x + self.self_attn(self.norm0(x))
        return x + self.ff(self.norm1(x))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ff: int, n_heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.rdt: Optional[torch.dtype] = None
        self.norm0 = layers.UnbiasedLayerNorm(d_model)
        self.self_attn = MultiHeadedAttention(n_heads, d_model, "qkv", generator=g)
        self.norm1 = layers.UnbiasedLayerNorm(d_model)
        self.src_attn = MultiHeadedAttention(n_heads, d_model, "kv", generator=g)
        self.norm2 = layers.UnbiasedLayerNorm(d_model)
        self.ff = FeedForward(d_model, d_ff, generator=g)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        if self.rdt is not None:
            x = x.to(self.rdt)
        x = x + self.self_attn(self.norm0(x))
        x = x + self.src_attn(self.norm1(x), memory)
        return x + self.ff(self.norm2(x))


class Transformer(nn.Module):
    """Pointer network: cross-attend src <-> tgt (reference dcp.py:304-328).
    One set of weights serves both directions."""

    def __init__(self, emb_dims: int = 512, n_blocks: int = 1, n_heads: int = 4,
                 ff_dims: int = 1024, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.encoder = nn.ModuleList(EncoderLayer(emb_dims, ff_dims, n_heads, g)
                                     for _ in range(n_blocks))
        self.decoder = nn.ModuleList(DecoderLayer(emb_dims, ff_dims, n_heads, g)
                                     for _ in range(n_blocks))
        self.enc_norm = layers.UnbiasedLayerNorm(emb_dims)
        self.dec_norm = layers.UnbiasedLayerNorm(emb_dims)

    def set_dtypes(self, dtype: Optional[torch.dtype],
                   rdt: Optional[torch.dtype]) -> None:
        """The sublayers' compute dtype and the residual stream's storage
        dtype (the JAX module's ``dtype``/``rdt`` fields); the final norms
        stay fp32."""
        for layer in (*self.encoder, *self.decoder):
            layer.rdt = rdt
            for m in layer.modules():
                if isinstance(m, (layers.TorchDense, layers.MultiDense,
                                  layers.UnbiasedLayerNorm)):
                    m.dtype = dtype

    def _run(self, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        m = s
        for layer in self.encoder:
            m = layer(m)
        m = self.enc_norm(m)
        x = t
        for layer in self.decoder:
            x = layer(x, m)
        return self.dec_norm(x)

    def forward(self, src: torch.Tensor, tgt: torch.Tensor):
        tgt_embedding = self._run(src, tgt)
        src_embedding = self._run(tgt, src)
        return src_embedding, tgt_embedding


def svd_head(src_embedding: torch.Tensor, tgt_embedding: torch.Tensor,
             src: torch.Tensor, tgt: torch.Tensor):
    """Soft correspondence + weighted Kabsch (reference dcp.py:338-381), all
    channels-last. The correspondence softmax(src_emb tgt_emb^T / sqrt(d)) @
    tgt is attention with the 3-wide target cloud as its value: the fp32
    kernel on the card. Returns R (B, 3, 3), t (B, 3)."""
    src_corr = layers.attention(src_embedding.to(torch.float32),
                                tgt_embedding.to(torch.float32), tgt)
    src_centered = src - src.mean(dim=1, keepdim=True)
    corr_centered = src_corr - src_corr.mean(dim=1, keepdim=True)
    H = torch.einsum("bnc,bnd->bcd", src_centered, corr_centered)
    R = layers.symmetric_svd_rotation(H)
    t = -torch.einsum("bij,bj->bi", R, src.mean(dim=1)) + src_corr.mean(dim=1)
    return R, t


def build(args=None, generator: Optional[torch.Generator] = None) -> "Model":
    """Registry factory (emb_dims fixed at 512, as the reference's
    Model.__init__, dcp.py:384-391)."""
    return Model(generator=generator)


class Model(nn.Module):
    """DCP-v2: forward(src, tgt, T_gt, prefix) like the JAX Model.

    prefix "test" (or T_gt None) returns T_12 (B, 4, 4); "val" and "train"
    return (loss, r_err, t_err, rmse, rt_mse), "train" with batch statistics
    (which move the running ones). One DGCNN serves src and tgt."""

    def __init__(self, emb_dims: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.emb_nn = DGCNN(emb_dims, generator=generator)
        self.transformer = Transformer(emb_dims, generator=generator)

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                T_gt: Optional[torch.Tensor] = None, prefix: str = "train"):
        train = prefix == "train"
        src_embedding = self.emb_nn(src, train)
        tgt_embedding = self.emb_nn(tgt, train)

        self.transformer.set_dtypes(
            torch.bfloat16 if TRANSFORMER_BF16 else None,
            torch.bfloat16 if TRANSFORMER_BF16 and TRANSFORMER_RESID_BF16 else None)
        src_p, tgt_p = self.transformer(src_embedding, tgt_embedding)
        src_embedding = src_embedding + src_p
        tgt_embedding = tgt_embedding + tgt_p

        R_ab, t_ab = svd_head(src_embedding, tgt_embedding, src, tgt)
        T_12 = metrics.rt_to_transformation(R_ab, t_ab[..., None])
        if T_gt is None:
            return T_12

        r_err = metrics.rotation_error(T_12[:, :3, :3], T_gt[:, :3, :3])
        t_err = metrics.translation_error(T_12[:, :3, 3], T_gt[:, :3, 3])
        rmse = metrics.rmse_loss(src, T_12, T_gt)
        eye = torch.eye(4, dtype=T_gt.dtype, device=T_gt.device).expand_as(T_gt)
        loss = torch.mean((torch.matmul(T_12, torch.linalg.inv(T_gt)) - eye) ** 2)
        rt_mse = (metrics.rotation_geodesic_error(T_12[:, :3, :3], T_gt[:, :3, :3])
                  + metrics.translation_error(T_12[:, :3, 3], T_gt[:, :3, 3]))
        return loss, r_err, t_err, rmse, rt_mse
