"""Roofline analysis (port of ``repro.launch.roofline``): per (arch x
shape), the three terms of one step on the production mesh

    compute    = FLOPs / (GPUs x 989 TFLOP/s bf16)
    memory     = HBM bytes / (GPUs x 3.35 TB/s)
    collective = collective bytes per GPU / 900 GB/s (NVLink)

for NVIDIA H100 SXM (``profiler.facts.hardware_constants``; a measured
``MachineFacts`` profile may replace them).  It is an analysis of a
256- or 512-GPU mesh, not a time measured on a card.

* Collective bytes come from the dry run's record (``launch/dryrun.py``):
  the bytes rank 0's collectives move over the whole step.
* FLOPs and HBM bytes use the explicit analytic model below (the JAX
  package's formulas, unchanged); the dry run's own per-device FLOP count
  is carried beside it as ``hlo_flops_body_once`` (the JAX key).
* MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); the ratio
  MODEL_FLOPS / total FLOPs exposes remat/attention/router overhead.

Records of either package's dry run read the same way.  ``CHIPS`` counts
the GPUs of each mesh by the port's names, the TPU meshes' by theirs.

Usage:
    python -m repro_torch.launch.roofline --dryrun results/dryrun_torch.jsonl \\
        --out results/roofline_torch.json --markdown results/roofline_torch.md
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.profiler.facts import hardware_constants, load_facts
from repro_torch.training.train_loop import decode_window_for

# devices per mesh: the port's H100 meshes (launch/mesh.py), and the JAX
# package's v5e meshes so its records read too
CHIPS = {"32x8": 256, "2x32x8": 512, "16x16": 256, "2x16x16": 512}


# ---------------------------------------------------------------------------
# analytic FLOPs / bytes
# ---------------------------------------------------------------------------

def _body_params(cfg) -> tuple[int, int]:
    """(dense-equivalent body params, active body params) excluding embed."""
    total = cfg.n_layers * cfg.layer_params
    if cfg.is_encoder_decoder:
        total += cfg.n_encoder_layers * cfg.layer_params
    if cfg.family == "moe":
        active_layer = cfg.attn_params + cfg.top_k * cfg.mlp_params \
            + cfg.d_model * cfg.n_experts
        active = cfg.n_layers * active_layer
        # capacity padding: experts compute ceil to capacity_factor
        compute = cfg.n_layers * (cfg.attn_params
                                  + cfg.capacity_factor * cfg.top_k
                                  * cfg.mlp_params)
        return int(compute), int(active)
    return total, total


def attn_flops(cfg, tokens: int, kv_len: int, window: Optional[int]) -> float:
    """QK^T + AV matmul flops (fwd) across all layers."""
    if cfg.family == "ssm":
        return 0.0
    eff = min(kv_len, window) if window else kv_len
    causal_frac = 0.5 if (cfg.causal and kv_len == tokens and not window) \
        else 1.0
    n_attn_layers = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn_layers = max(1, cfg.n_layers // max(cfg.attn_every, 1))
    per_tok = 4 * eff * cfg.d_model * causal_frac
    fl = tokens * per_tok * n_attn_layers
    if cfg.is_encoder_decoder:
        fl += cfg.encoder_len * 4 * cfg.encoder_len * cfg.d_model \
            * cfg.n_encoder_layers                       # encoder self-attn
        fl += tokens * 4 * cfg.encoder_len * cfg.d_model * cfg.n_layers  # cross
    return fl


def ssm_flops(cfg, tokens: int) -> float:
    """SSD / recurrent extra flops (state updates) per fwd."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    from repro_torch.models.ssm import mamba2_dims
    if cfg.family == "hybrid":
        d_in, h, p, n = mamba2_dims(cfg)
        per_tok = 2 * h * (cfg.ssm_chunk * (n + p) + 2 * p * n)
        return tokens * per_tok * cfg.n_layers
    # xlstm: mLSTM matrix memory (n = p) + sLSTM vector ops
    d_in = cfg.ssm_expand * cfg.d_model
    p = d_in // cfg.n_heads
    per_tok = 2 * cfg.n_heads * (cfg.ssm_chunk * 2 * p + 2 * p * p)
    return tokens * per_tok * (cfg.n_layers // 2)


def analytic_step(cfg, shape) -> dict:
    """Global FLOPs and HBM bytes for one step of the shape's program."""
    b, s = shape.global_batch, shape.seq_len
    V, d = cfg.vocab_size, cfg.d_model
    window = decode_window_for(cfg, shape) or cfg.window
    body, active = _body_params(cfg)
    emb_unembed = 2 * d * V            # unembed matmul params-equivalent

    if shape.kind == "train":
        tokens = b * s
        fwd = 2 * tokens * (body + emb_unembed) \
            + attn_flops(cfg, tokens, s, window) + ssm_flops(cfg, tokens)
        flops = 4 * fwd                 # bwd 2x + full remat recompute 1x
        model_flops = 6 * tokens * (active + emb_unembed // 2)
        # HBM: param/grad/opt traffic (f32 master + bf16 cast) + activations
        state_bytes = (body + V * d) * (4 * 7)   # p,g,mu,nu r/w per step
        act_bytes = tokens * d * 20 * (cfg.n_layers + getattr(
            cfg, "n_encoder_layers", 0))
        hbm = state_bytes + act_bytes
    elif shape.kind == "prefill":
        tokens = b * s
        flops = 2 * tokens * body + 2 * b * (emb_unembed // 2) \
            + attn_flops(cfg, tokens, s, window) + ssm_flops(cfg, tokens)
        model_flops = 2 * tokens * active
        hbm = (body + V * d) * 2 + tokens * d * 12 * cfg.n_layers
    else:  # decode: one token against a seq_len cache/state
        tokens = b
        kv_len = s
        flops = 2 * tokens * (active + emb_unembed) \
            + attn_flops(cfg, tokens, kv_len, window) + ssm_flops(cfg, tokens)
        model_flops = 2 * tokens * active
        # HBM: weights once + KV cache read (the decode wall)
        eff = min(kv_len, window) if window else kv_len
        if cfg.family in ("ssm", "hybrid"):
            from repro_torch.models.ssm import mamba2_dims
            state = b * cfg.n_layers * 2 * d * 64 * 4    # rough state bytes
            kv_bytes = state
        else:
            kv_bytes = (b * cfg.n_layers * 2 * eff
                        * cfg.n_kv_heads * cfg.head_dim * 2)
        if cfg.family == "hybrid":
            n_attn = max(1, cfg.n_layers // max(cfg.attn_every, 1))
            kv_bytes += b * n_attn * 2 * eff * cfg.n_kv_heads \
                * cfg.head_dim * 2
        hbm = (active + V * d) * 2 + kv_bytes * 2        # read + write
    return {"flops": flops, "model_flops": model_flops, "hbm_bytes": hbm}


# ---------------------------------------------------------------------------
# assembling the table
# ---------------------------------------------------------------------------

def lever_for(dominant: str, cfg, shape) -> str:
    if dominant == "compute":
        return ("tensor-core utilization: route attention through the "
                "flash kernel (kernels/csrc/flash_attention.cu) and cut remat "
                "recompute with a coarser checkpoint policy")
    if dominant == "memory":
        if shape.kind == "decode":
            return ("KV/state residency dominates: quantize cache to int8 or "
                    "shrink window; batch more requests per step")
        return ("HBM-bound: raise arithmetic intensity — larger micro-batch "
                "per device or fuse norm/residual round-trips")
    return ("collective-bound: reshard to cut all-gathers (wider FSDP axis), "
            "overlap NCCL collectives with compute, or move to bf16 gathers")


def analyze(records: list[dict], facts=None) -> list[dict]:
    """``facts`` (a ``repro_torch.profiler.MachineFacts``) overrides the
    analytic H100 constants with measured ones; None keeps the analytic
    table.  A record of a reduced config (``"smoke": true``, which only
    the port's dry run writes) is priced as that config."""
    hw = hardware_constants(facts)
    out = []
    for rec in records:
        if rec.get("status") != "ok":
            out.append(dict(rec, roofline=None))
            continue
        cfg = get_config(rec["arch"], smoke=rec.get("smoke", False))
        shape = INPUT_SHAPES[rec["shape"]]
        chips = CHIPS[rec["mesh"]]
        a = analytic_step(cfg, shape)
        t_compute = a["flops"] / (chips * hw["peak_flops_bf16"])
        t_memory = a["hbm_bytes"] / (chips * hw["hbm_bw"])
        coll_bytes = rec["collectives"].get("total", 0)   # per device
        t_coll = coll_bytes / hw["ici_bw"]
        terms = {"compute": t_compute, "memory": t_memory,
                 "collective": t_coll}
        dominant = max(terms, key=terms.get)
        out.append(dict(
            rec,
            roofline={
                "t_compute_s": t_compute,
                "t_memory_s": t_memory,
                "t_collective_s": t_coll,
                "dominant": dominant,
                "hw_source": hw["source"],
                "model_flops": a["model_flops"],
                "total_flops": a["flops"],
                "useful_ratio": a["model_flops"] / max(a["flops"], 1),
                "hlo_flops_body_once": rec.get("hlo_flops_per_device", 0),
                "lever": lever_for(dominant, cfg, shape),
            }))
    return out


def to_markdown(rows: list[dict]) -> str:
    lines = ["| arch | shape | mesh | compute s | memory s | collective s "
             "| dominant | useful FLOP ratio | peak GB/dev |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        rf = r.get("roofline")
        if rf is None:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — "
                         f"| — | FAILED | — | — |")
            continue
        peak = r["bytes_per_device"]["peak"] / 1e9
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {rf['t_compute_s']:.3e} | {rf['t_memory_s']:.3e} "
            f"| {rf['t_collective_s']:.3e} | **{rf['dominant']}** "
            f"| {rf['useful_ratio']:.2f} | {peak:.2f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun_torch.jsonl")
    ap.add_argument("--out", default="results/roofline_torch.json")
    ap.add_argument("--markdown", default="results/roofline_torch.md")
    ap.add_argument("--profile", default=None,
                    help="MachineFacts JSON whose measured hardware "
                    "constants replace the analytic H100 table")
    args = ap.parse_args(argv)
    records = [json.loads(l) for l in open(args.dryrun)]
    facts = load_facts(args.profile, require_fresh=False) \
        if args.profile else None
    rows = analyze(records, facts=facts)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    md = to_markdown(rows)
    with open(args.markdown, "w") as f:
        f.write(md + "\n")
    print(md)
    return rows


if __name__ == "__main__":
    main()
