"""Shared building blocks for the LM zoo.

Dtype policy (as the JAX package's): parameters are stored in
``cfg.param_dtype``; matmuls take operands rounded to ``cfg.compute_dtype``
(bf16) and return float32 products.  ``mm`` computes that as a float32
GEMM of the rounded operands on every device -- a ``matmul`` of bf16
tensors would return bf16, a different function -- so TF32 must stay off
for float32 matmuls on the card.  PyTorch's default is off; it is set
here so that the model's function does not depend on a caller's setting.

The JAX package's model code marks activations with
``distributed/ctx.py::constrain`` for its sharded dry run; on one card
those calls are no-ops, and the port's models make none.  Its structural
``scan``/``unroll_scans`` (the dry run's cost analysis) are not ported
here (ROADMAP queue 1 item 8); the training loss (``softmax_xent``,
``chunked_lm_loss``) is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.checkpoint import checkpoint

torch.backends.cuda.matmul.allow_tf32 = False


def mm(x, w, compute_dtype=torch.bfloat16):
    """Matmul with ``compute_dtype`` inputs, float32 accumulation and
    result (``x [..., d_in] @ w [d_in, d_out]``)."""
    return torch.matmul(x.to(compute_dtype).to(torch.float32),
                        w.to(compute_dtype).to(torch.float32))


def normal(gen, shape, scale, dtype, device="cpu"):
    """Normal(0, scale) values of ``shape``, drawn in float32 on ``gen``'s
    own device -- a CPU ``torch.Generator`` gives the same values on every
    device, a CUDA one draws a full-width model's billions of weights on
    the card -- then moved to ``device`` in ``dtype``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return w.to(dtype=dtype, device=device)


def dense_init(gen, d_in, d_out, dtype, scale=None, device="cpu"):
    """Normal(0, scale) weights ``[d_in, d_out]`` drawn from ``gen``
    (:func:`normal`); the scale defaults to ``d_in ** -0.5``."""
    scale = scale if scale is not None else (d_in ** -0.5)
    return normal(gen, (d_in, d_out), scale, dtype, device)


def embed(emb, tokens):
    """Rows ``tokens`` of the embedding ``emb [V, d]``, float32.

    ``F.embedding`` rather than ``emb[tokens]``: the two gather alike, but
    the indexing's backward is ``index_put_(accumulate=True)``, whose
    parallel CPU kernel adds repeated tokens' gradients in a varying
    order, while the embedding's backward adds them in a fixed order on
    the CPU and sorts them on the card -- a training step gives the same
    bits on every run, and a resumed run the uninterrupted one's."""
    return F.embedding(tokens, emb).to(torch.float32)


def rms_norm(x, gamma, eps=1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return x32 * torch.rsqrt(var + eps) * gamma.to(torch.float32)


def layer_norm(x, gamma, beta, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * gamma.to(torch.float32) \
        + beta.to(torch.float32)


def rope_tables(positions, head_dim, theta=1e4):
    """positions: int[...]; returns (cos, sin) with trailing dim
    head_dim // 2."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [..., S, H, D]; cos/sin: [..., S, D//2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :] if x.dim() == cos.dim() + 2 else cos
    s = sin[..., None, :] if x.dim() == sin.dim() + 2 else sin
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def swiglu(x_gate, x_up):
    return F.silu(x_gate) * x_up


def softmax_xent(logits, labels, vocab=None):
    """Mean token cross-entropy; logits float32 [N, V], labels int [N].
    The row max is a constant to the gradient, as in JAX.  ``vocab`` is
    unused (the JAX signature's)."""
    del vocab
    logits = logits.to(torch.float32)
    lmax = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - lmax), dim=-1)) + lmax[..., 0]
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return (lse - gold).mean()


def chunked_lm_loss(x, emb, labels, n_chunks: int = 8,
                    compute_dtype=torch.bfloat16):
    """Cross-entropy over tied-embedding logits without materialising the
    full [B, S, V] tensor: the mean of the per-chunk means over
    ``n_chunks`` sequence chunks (lowered until it divides S), added in
    chunk order.  Each chunk's body runs under ``torch.utils.checkpoint``
    (``jax.checkpoint`` in JAX): its logits are recomputed in the
    backward pass, so at most one chunk's are live.

    x: [B, S, d] final hidden states; emb: [V, d]; labels: [B, S].
    """
    B, S, d = x.shape
    V = emb.shape[0]
    while S % n_chunks:
        n_chunks -= 1
    c = S // n_chunks

    def body(xi, li, emb):
        logits = mm(xi, emb.T, compute_dtype)            # [B, c, V] f32
        return softmax_xent(logits.reshape(-1, V), li.reshape(-1), V)

    total = torch.zeros((), device=x.device)
    for i in range(n_chunks):
        total = total + checkpoint(body, x[:, i * c:(i + 1) * c],
                                   labels[:, i * c:(i + 1) * c], emb,
                                   use_reentrant=False)
    return total / n_chunks


def chunked_time_scan(step, carry0, seq):
    """Recurrence over time: ``step(carry, x_t) -> (carry, y_t)`` for t in
    order over ``seq``, a pytree with a leading time axis T; returns the
    last carry and the ``y_t`` stacked on a leading T axis.

    A host loop over t.  The JAX version scans in chunks, rematerialised,
    which changes only what a backward pass keeps: its forward result is
    that of one ``lax.scan`` for every T, and so is this one's.
    """
    leaves, spec = tree_flatten(seq)
    carry, ys = carry0, []
    for t in range(leaves[0].shape[0]):
        carry, y = step(carry, tree_unflatten([a[t] for a in leaves], spec))
        ys.append(y)
    y_leaves = [tree_flatten(y)[0] for y in ys]
    stacked = [torch.stack([yl[i] for yl in y_leaves])
               for i in range(len(y_leaves[0]))]
    return carry, tree_unflatten(stacked, tree_flatten(ys[0])[1])
