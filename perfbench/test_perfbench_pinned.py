"""Readings that no reorganisation of the harness may change, pinned as
they read before the architecture moved into ``families/``: at the
published sizes, the counts the rooflines and shares divide by; at each
reduced configuration on the CPU, from one seed, a digest of every weight
tensor and of the reference's logits over one fixed sequence, its loss,
and the train reference's first three steps. Each is compared exactly."""
import hashlib
import json

import pytest
import torch

from perfbench import harness, spec, testing
from perfbench.counts import decode, model
from perfbench.reference.model import build, forward_logits
from perfbench.reference.train import flat, reference_steps
from perfbench.weights import make_params

BENCH = spec.benchmark()

COUNTS = {
    "mamba2_370m": {
        "leaves": {"embed": 51511296, "layers": 316740096,
                   "final_norm": 1024},
        "param_count": 368252416, "flops_params": 368252416,
        "bfloat16": {"weight_bytes": 736761856, "state_bytes": 50995200,
                     "kv_row_bytes": 0, "step_bytes": 7264147456},
        "float32": {"weight_bytes": 1472911360, "state_bytes": 51658752,
                    "kv_row_bytes": 0, "step_bytes": 8085231616},
    },
    "zamba2_1p2b": {
        "leaves": {"embed": 65536000, "layers": 972126336,
                   "final_norm": 2048, "shared": 167780352,
                   "proj": 58720256},
        "param_count": 1264164992, "flops_params": 2270847104,
        "bfloat16": {"weight_bytes": 2528832000, "state_bytes": 40808960,
                     "kv_row_bytes": 114688, "step_bytes": 19228518912},
        "float32": {"weight_bytes": 5056659968, "state_bytes": 41772032,
                    "kv_row_bytes": 229376, "step_bytes": 33355760128},
    },
}

#: (cell whose configuration is reduced, weights in bf16 and in fp32,
#: logits in fp32 and fp8, loss)
REDUCED = {
    "mamba2-gen": (
        "37afb76208969ee312af02cd703f5157d5d1a62b446fb435de239490cf110ea7",
        "96fd2322fe7c335c4fc6d53c1a668ec7b73cc81746e08d40efefbceb5c1d65ed",
        "7ef6f1722bcf26e3524eab0b17791e3e5c5a99f01117e702e4085220c483e08e",
        "5528bca6f16af3f24f02961ea00576581d4d067573dc1203dd464ab8eea22b7b",
        6.312064170837402),
    "zamba2-longctx": (
        "d7c226b30a50e9665d3bf7fe4445653cfe2bd1425a376c7fef9b0829a4388845",
        "2ae61df347abc6847f300b7d5bd7d4e8093fd256266b096eaae37f8eb842cbae",
        "7218da1decea6f04485531f45f1bbe5026357db3a827c86e3a90340270eac5f5",
        "d53072d028dcda3a8966ef62b4386642bb24719ad3db9f44c1411ae7d2cf1f6e",
        6.207770824432373),
}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_the_counts_at_the_published_sizes(name):
    m = spec.config(name, BENCH)["model"]
    want = COUNTS[name]
    got = {"leaves": model.leaves(m), "param_count": model.param_count(m),
           "flops_params": model.flops_params(m)}
    for dt in ("bfloat16", "float32"):
        got[dt] = {"weight_bytes": decode.weight_bytes(m, dt),
                   "state_bytes": decode.state_bytes(m, dt),
                   "kv_row_bytes": decode.kv_row_bytes(m, dt),
                   "step_bytes": decode.step_bytes(m, dt, 64, 10 ** 5)}
    assert got == want


def _digest(tree):
    h = hashlib.sha256()
    for k, t in sorted(flat(tree).items()):
        t = t.detach().cpu().contiguous()
        h.update(f"{k}:{tuple(t.shape)}:{t.dtype};".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cell", sorted(REDUCED))
def test_weights_logits_and_loss_at_the_reduced_sizes(cell):
    w_bf16, w_fp32, lg_fp32, lg_fp8, loss = REDUCED[cell]
    conf = testing.small(cell)["conf"]
    m = conf["model"]
    params = {path: make_params(harness.program_config(conf, path),
                                testing.SEED, "cpu")
              for path in ("serve", "train")}
    assert _digest(params["serve"]) == w_bf16
    assert _digest(params["train"]) == w_fp32
    toks = ((torch.arange(40) * 37 + 11) % m["vocab_size"])[None]
    for prec, want in (("fp32", lg_fp32), ("fp8", lg_fp8)):
        lg = forward_logits(build(m, prec), params["serve"], toks, 0)
        assert hashlib.sha256(
            lg.contiguous().numpy().tobytes()).hexdigest() == want, prec
    with torch.no_grad():
        assert float(build(m).loss(params["train"], toks)) == loss


#: the train reference's three losses and a digest of its per-leaf norms
#: (first gradient, change), from the cell's own token source
STEPS = {
    "mamba2-train": (
        [6.269172191619873, 6.249361753463745, 6.311456203460693],
        "68509688bf2d1a8712d7ab761a91e1beab59ba14210bc203480b804001bd7f1d"),
    "zamba2-train": (
        [6.252496719360352, 6.285322427749634, 6.2762486934661865],
        "c06b47cba7723c23225b68bd02257af692f395f7e859e5e64060e3b81b5d075a"),
}


@pytest.mark.parametrize("cell", sorted(STEPS))
def test_the_train_reference_at_the_reduced_sizes(cell):
    from perfbench.train_cell import TokenSource
    losses, norms = STEPS[cell]
    conf = testing.small(cell)["conf"]
    cfg = harness.program_config(conf, "train")
    source = TokenSource(cfg.vocab_size, 2, 64, testing.SEED)
    opt = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "lr": 3e-4,
           "weight_decay": 0.1, "grad_clip": 1.0}
    ref = reference_steps(conf["model"], make_params(cfg, testing.SEED, "cpu"),
                          [source.tokens(i) for i in range(3)], opt, "cpu")
    assert ref["loss"] == losses
    got = {k: {leaf: repr(v) for leaf, v in ref[k].items()}
           for k in ("grad", "update")}
    assert hashlib.sha256(json.dumps(got, sort_keys=True).encode()
                          ).hexdigest() == norms
