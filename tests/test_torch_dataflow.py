"""The two-cut-point dataflow audit of the port on a real split: four
gloo ranks at mesh (data 1, model 4) run one forward of the one-layer
variant of the reference test's widened granite-3-2b and rwkv6-7b
configs (d_model 128, d_ff 256, 8 / 8 heads x 16, vocab 256) and count
the collectives each issues through `repro_torch.sharding`'s counted
wrappers; the budget is the reference test's, verbatim. Plus the
collectives of one batched decode step, and a grep that no collective
bypasses the counted wrappers."""

import pathlib
import re

import pytest
from torch_sharded_worker import spawn

SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
WIDE = dict(param_dtype="float32", compute_dtype="bfloat16", d_model=128,
            d_ff=256, num_heads=8, num_kv_heads=8, head_dim=16,
            vocab_size=256)


@pytest.fixture(scope="module")
def audit(tmp_path_factory):
    payload = {"configs": {"granite-3-2b": WIDE, "rwkv6-7b": WIDE}}
    res = spawn("dataflow", payload, (1, 4),
                tmp_path_factory.mktemp("dataflow"))
    assert all(r == res[0] for r in res), res       # every rank alike
    return res[0]


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-7b"])
def test_per_layer_collective_budget(audit, arch):
    """One-layer forward: the TP reductions at exactly the two cut
    points (AttnOut, FFNOut) plus the vocab-parallel embedding's
    reduction and the head's gather; nothing inside a fused region."""
    counts = audit[arch]["forward"]
    assert sum(counts.values()) <= 5, (arch, counts)
    assert counts.get("all-reduce", 0) >= 2, (arch, counts)
    assert counts == {"all-reduce": 3, "all-gather": 1}, counts


def test_decode_step_collectives(audit):
    """One batched decode step, per layer: granite (tiered store, kv heads
    split 2 a rank) gathers its K and V stores' hot ring, cold codes and
    cold scales at use (6) and the new K/V rows (2), and reduces at the
    two cut points (2); rwkv6 (heads split, state kept local) reduces at
    its two cut points only. The embedding reduces once a step, the
    greedy head gathers once."""
    g = audit["granite-3-2b"]["decode"]
    assert g["layers"] == {"all-gather": 8, "all-reduce": 2}, g
    r = audit["rwkv6-7b"]["decode"]
    assert r["layers"] == {"all-reduce": 2}, r
    for d in (g, r):
        assert d["embed"] == {"all-reduce": 1}
        assert d["head"] == {"all-gather": 1}


def test_no_collective_bypasses_the_counted_wrappers():
    """Every torch.distributed collective of the port is called in
    sharding.py, inside its counted wrappers."""
    call = re.compile(r"\b(all_reduce|all_gather\w*|reduce_scatter\w*|"
                      r"broadcast\w*|all_to_all\w*|send|recv|isend|irecv|"
                      r"batch_isend_irecv|reduce|scatter|gather)\s*\(")
    dist_use = re.compile(r"\b(dist|torch\.distributed|_dist\(\))\.")
    offenders = []
    for path in SRC.rglob("*.py"):
        if path.name == "sharding.py" and path.parent == SRC:
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#")[0]
            if dist_use.search(code) and call.search(code):
                offenders.append(f"{path.relative_to(SRC)}:{i}: {line}")
            if re.search(r"torch\.distributed\.\w*(all_|reduce|broadcast|"
                         r"send|recv|gather|scatter)", code):
                offenders.append(f"{path.relative_to(SRC)}:{i}: {line}")
    assert not offenders, offenders
    text = (SRC / "sharding.py").read_text()
    for wrapper in ("def all_reduce", "def all_gather", "def reduce_scatter",
                    "def broadcast", "def send", "def recv"):
        assert wrapper in text
    assert text.count("_count(") >= 7      # the helper and one a wrapper
