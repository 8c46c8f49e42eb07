"""Parameters of a configuration's model, from its sizes (a
configuration file's ``model`` section), leaf by leaf as the weights are
laid out."""
from __future__ import annotations

from typing import Any, Dict, Mapping


def leaves(m: Mapping[str, Any]) -> Dict[str, int]:
    """Elements of each weight group: the embedding table (``padded_vocab``
    rows as made, of which ``vocab_size`` are tokens), the layer stack, the
    final norm and (hybrid) the shared block without and with its
    per-site projectors."""
    s = m["ssm"]
    d, L = m["d_model"], m["n_layers"]
    di = s["expand"] * d
    H, N, G, W = di // s["head_dim"], s["state_dim"], s["n_groups"], \
        s["conv_width"]
    per = (d * (2 * di + 2 * G * N + H) + W * (di + 2 * G * N)
           + 3 * H + di + di * d + d)
    out = {"embed": m["padded_vocab"] * d, "layers": L * per,
           "final_norm": d}
    if m["family"] == "hybrid":
        w, hd, ff = 2 * d, m["head_dim"], m["d_ff"]
        nh, kv = m["n_heads"], m["n_kv_heads"]
        out["shared"] = (2 * w + w * hd * (2 * nh + 2 * kv) + 3 * w * ff)
        out["proj"] = sites(m) * w * d
    return out


def sites(m: Mapping[str, Any]) -> int:
    """Shared-block sites: before layers 0, every, 2 every, ..."""
    return -(-m["n_layers"] // m["hybrid_attn_every"])


def param_count(m: Mapping[str, Any]) -> int:
    return sum(leaves(m).values())


def flops_params(m: Mapping[str, Any]) -> int:
    """N of "2 N a token to infer, 6 N to train": every weight a token
    passes through, the shared block once a site (``family_model_flops``
    of ``chip_smoke.py``)."""
    lv = leaves(m)
    n = sum(lv.values())
    if m["family"] == "hybrid":
        n += (sites(m) - 1) * lv["shared"]
    return n
