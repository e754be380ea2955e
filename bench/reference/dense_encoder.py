"""Plain reference of the dense pre-norm encoder block and its training
step: the frozen equations that the benchmark holds the port to.

It imports torch alone — nothing of the port — and computes in float32
with TF32 off.  Its equations, as the port's dense family states them:

    x   = embeds (a family fed embeddings) or table[tokens]
    per layer:  h = LN1(x);  q, k, v = h Wq (+bq), h Wk (+bk), h Wv (+bv)
                q, k = rope(q), rope(k)          (split halves, theta)
                a = softmax(q k^T / sqrt(hd)) v  (no mask: non-causal)
                x = x + a Wo
                x = x + W_out gelu_tanh(LN2(x) W_in + b_in) + b_out
    logits = LN_f(x) table^T                     (tied, f32)
    loss   = mean over every position of logsumexp(logits) - logit[label]

    AdamW per leaf (no clipping; decay on every leaf):
      m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
      p = p - lr ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

LN is LayerNorm with eps 1e-5 and a scale and a bias.  ``precision``
"fp8" is the control: every product's operands rounded to float8 e4m3
with one scale a tensor (amax to 448), the gradient passed straight
through; the rest stays float32.  ``rows="half"`` is a planted fault:
the loss is the mean over the first half of the batch's rows.
"""

from __future__ import annotations

import contextlib
import math

import torch

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.95, 1e-8, 0.01
LN_EPS = 1e-5


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 on the card, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at one scale for the tensor; the gradient
    passes straight through."""
    amax = t.detach().abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t.detach())


class _Ops:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision={precision!r}: 'f32' or 'fp8'")
        self.fp8 = precision == "fp8"

    def mm(self, a, b):
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return a @ b


def layer_norm(x, scale, bias):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * scale + bias


def rope(x, theta):
    """x: (b, s, h, hd); rotate split halves by position."""
    hd, s = x.shape[-1], x.shape[1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def block(arch, lp, x, ops):
    b, s, d = x.shape
    nh, nkv = arch["n_heads"], arch["n_kv_heads"]
    hd = arch["head_dim"] or d // nh
    h = layer_norm(x, lp["attn_norm.scale"], lp["attn_norm.bias"])
    q, k, v = (ops.mm(h, lp["attn.wq"]), ops.mm(h, lp["attn.wk"]),
               ops.mm(h, lp["attn.wv"]))
    if arch["qkv_bias"]:
        q, k, v = q + lp["attn.bq"], k + lp["attn.bk"], v + lp["attn.bv"]
    q = rope(q.reshape(b, s, nh, hd), arch["rope_theta"])
    k = rope(k.reshape(b, s, nkv, hd), arch["rope_theta"])
    v = v.reshape(b, s, nkv, hd)
    rep = nh // nkv
    q = q.permute(0, 2, 1, 3)                                 # b h s hd
    k = k.permute(0, 2, 3, 1).repeat_interleave(rep, dim=1)   # b h hd s
    v = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)   # b h s hd
    p = torch.softmax(ops.mm(q, k) / math.sqrt(hd), dim=-1)
    a = ops.mm(p, v).permute(0, 2, 1, 3).reshape(b, s, nh * hd)
    x = x + ops.mm(a, lp["attn.wo"])
    h = layer_norm(x, lp["mlp_norm.scale"], lp["mlp_norm.bias"])
    h = gelu_tanh(ops.mm(h, lp["mlp.w_in"]) + lp["mlp.b_in"])
    return x + ops.mm(h, lp["mlp.w_out"]) + lp["mlp.b_out"]


def forward_logits(arch, leaves, batch, ops):
    """(b, s, vocab) logits of ``batch``."""
    if arch["takes_embeddings"]:
        x = batch["embeds"].float()
    else:
        x = leaves["embed.table"][batch["tokens"]]
    for i in range(arch["n_layers"]):
        pre = f"layers.{i}."
        lp = {k[len(pre):]: v for k, v in leaves.items()
              if k.startswith(pre)}
        x = block(arch, lp, x, ops)
    x = layer_norm(x, leaves["final_norm.scale"], leaves["final_norm.bias"])
    return ops.mm(x, leaves["embed.table"].t())


def forward_loss(arch, leaves, batch, ops):
    """Mean cross-entropy of ``batch`` (rows given) over every position."""
    logits = forward_logits(arch, leaves, batch, ops)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    return (logz - gold).mean()


def unstack(weights: dict) -> dict:
    """The stacked weight tree as f32 leaves named like the norms are
    reported: ``embed.table``, ``layers.<i>.attn.wq``, ``final_norm.bias``."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        if path[0] == "layers":
            for i in range(node.shape[0]):
                out[".".join(("layers", str(i)) + path[1:])] = \
                    node[i].detach().float().clone()
        else:
            out[".".join(path)] = node.detach().float().clone()

    walk(weights, ())
    return out


def _row_chunks(batch: dict, rows: str, chunk_tokens: int):
    """(chunk, share of the loss) over the rows the loss is taken on."""
    n = batch["labels"].shape[0]
    used = n // 2 if rows == "half" else n
    if rows not in ("all", "half") or used < 1:
        raise ValueError(f"rows={rows!r} on a batch of {n}")
    step = max(1, chunk_tokens // batch["labels"].shape[1])
    for lo in range(0, used, step):
        hi = min(used, lo + step)
        yield {k: v[lo:hi] for k, v in batch.items()}, (hi - lo) / used


def _leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def train(arch: dict, weights: dict, batches: list, *, lr: float,
          precision: str = "f32", rows: str = "all",
          chunk_tokens: int = 2048) -> dict:
    """``len(batches)`` AdamW steps from ``weights``: each step's loss,
    every leaf's first-gradient norm and every leaf's change norm after
    the last step (``{"losses", "grad", "change"}``)."""
    ops = _Ops(precision)
    with exact_f32():
        p0 = unstack(weights)
        params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        m = {k: torch.zeros_like(v) for k, v in p0.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p0.items()}
        losses, grad = [], None
        for t, batch in enumerate(batches, start=1):
            total = 0.0
            for chunk, share in _row_chunks(batch, rows, chunk_tokens):
                loss = forward_loss(arch, params, chunk, ops) * share
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            with torch.no_grad():
                if grad is None:
                    grad = _leaf_norms({k: p.grad for k, p in params.items()})
                bc1, bc2 = 1 - B1 ** t, 1 - B2 ** t
                for k, p in params.items():
                    g = p.grad
                    m[k].mul_(B1).add_((1 - B1) * g)
                    v2[k].mul_(B2).add_((1 - B2) * g * g)
                    upd = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + EPS)
                    p.sub_(lr * (upd + WEIGHT_DECAY * p))
                    p.grad = None
        change = _leaf_norms({k: params[k].detach() - p0[k] for k in p0})
    return {"losses": losses, "grad": grad, "change": change}


def eval_loss(arch: dict, weights: dict, batch: dict, *,
              precision: str = "f32", rows: str = "all",
              chunk_tokens: int = 4096) -> float:
    """The mean cross-entropy of one batch, forward only."""
    ops = _Ops(precision)
    leaves = unstack(weights)
    total = 0.0
    with exact_f32(), torch.no_grad():
        for chunk, share in _row_chunks(batch, rows, chunk_tokens):
            total += float(forward_loss(arch, leaves, chunk, ops)) * share
    return total
