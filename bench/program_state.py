"""What the benchmark reads back from the program after its first steps:
the norm of each leaf's first gradient, worked out from the AdamW state
in a grid model's host store after one step (m = (1 - b1) g), and the
norm of each leaf's change after the checked steps, read from the store
before the next step writes it.

The leaves are named as the reference names them: ``embed.table``,
``layers.<i>.attn.wq``, ``final_norm.bias``.  Everything is read through
the store's public attributes (``opt``, ``shared_opt``, ``plan``,
``partition``, ``opt_cfg``, ``model_params()``) and reduced on the
store's device.
"""

from __future__ import annotations

import torch

from bench import gen


def _walk(tree, prefix, out):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            _walk(v, f"{prefix}.{k}" if prefix else k, out)
    elif isinstance(tree, (tuple, list)):
        raise TypeError(f"{prefix}: a sequence where a leaf tree was meant")
    else:
        out[prefix] = tree


def _norm(t: torch.Tensor, device) -> float:
    return float(torch.linalg.vector_norm(t.to(device), dtype=torch.float64))


def first_grad_norms(store) -> dict:
    """{leaf: |g|} from the store's AdamW moments after exactly one step."""
    scale = 1.0 - store.opt_cfg.b1
    dev = store.device
    out: dict = {}
    for shard in store.partition.shards:
        mu = store.opt[shard.index]["mu"]
        for k, i in enumerate(range(shard.seg_lo, shard.seg_hi)):
            ref = store.plan.segments[i].param_ref
            if ref is None:
                continue
            leaves: dict = {}
            _walk(mu[k], "", leaves)
            for path, t in leaves.items():
                if ref[0] == "stack_slice":
                    _, key, lo, hi = ref
                    for j in range(hi - lo):
                        out[f"{key}.{lo + j}.{path}"] = \
                            _norm(t[j], dev) / scale
                else:
                    out[".".join(ref) + "." + path] = _norm(t, dev) / scale
    for name, ref in store.plan.shared_refs.items():
        leaves = {}
        _walk(store.shared_opt[name]["mu"], "", leaves)
        for path, t in leaves.items():
            out[".".join(ref) + "." + path] = _norm(t, dev) / scale
    return out


def change_norms(store, fam, arch: dict, seed: int, model: int) -> dict:
    """{leaf: |p_now - p_start|}, the start drawn again from the seed."""
    dev = store.device
    now: dict = {}
    _walk(store.model_params(), "", now)
    out = {}
    for name, t in now.items():
        diff = t.to(dev) - gen.make_leaf(fam, arch, seed, model, name, dev)
        if name.startswith("layers."):
            per = torch.linalg.vector_norm(diff.flatten(1), dim=1,
                                           dtype=torch.float64)
            rest = name[len("layers."):]
            for i, v in enumerate(per.tolist()):
                out[f"layers.{i}.{rest}"] = v
        else:
            out[name] = float(torch.linalg.vector_norm(
                diff, dtype=torch.float64))
        del diff
    return out
