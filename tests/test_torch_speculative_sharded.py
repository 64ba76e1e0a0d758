"""The port's sharded speculative decoding (mpistragglers_jl_tpu_torch/
models/speculative.py ``make_speculative``) on CPU ranks against the
JAX package's ``make_speculative`` on its host devices and the port's
dense program: the mesh cases of the JAX package's
tests/test_speculative.py, parameters carried over by
``params_from_jax``. And the port's ``dryrun_multichip`` (parallel/
dryrun.py) on eight CPU ranks: every leg of the reference's dry run.

Tolerances: tokens and verify-forward counts equal; every rank's token
buffer bit-equal to rank 0's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mpistragglers_jl_tpu.models import speculative as js
from mpistragglers_jl_tpu.models import transformer as jt
from mpistragglers_jl_tpu.parallel import make_mesh as jmake_mesh
from mpistragglers_jl_tpu_torch.models import speculative as ts
from mpistragglers_jl_tpu_torch.models import transformer as tt
from mpistragglers_jl_tpu_torch.parallel import PartitionSpec as P, make_mesh

CFG = dict(vocab=61, d_model=48, n_heads=4, n_layers=2, d_ff=96)
GQA = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, attn="ulysses")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(fields, seed):
    jcfg = jt.TransformerConfig(**fields)
    jp = jt.init_params(jcfg, seed)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tt.TransformerConfig(**fields), jp, tp


def _prompt(vocab, L, seed):
    return np.random.default_rng(seed).integers(0, vocab, (1, L),
                                                dtype=np.int32)


@pytest.mark.parametrize("fields,tp,Tp,n_new,k,layers,seed", [
    (CFG, 2, 8, 15, 4, None, 44),  # tests/test_speculative.py:92
    (CFG, 4, 8, 15, 4, None, 44),
    (CFG, 4, 8, 12, 3, 1, 45),     # :187, the truncated-layer drafter
    (GQA, 4, 8, 5, 3, None, 0),    # dryrun leg 6's GQA kv=2 < tp=4
    (GQA, 4, 8, 5, 3, 1, 0),
])
def test_sharded_speculative_matches_jax(fields, tp, Tp, n_new, k, layers,
                                         seed):
    """Tokens and verify forwards equal the JAX mesh program's packed
    output and the port's dense program's; every rank's buffer is
    bit-equal."""
    jcfg, tcfg, jp, tparams = _pair(fields, seed=4)
    prompt = _prompt(fields["vocab"], Tp, seed)
    jmesh = jmake_mesh((1, tp), ("dp", "tp"))
    packed = np.asarray(js.make_speculative(
        jcfg, jmesh, Tp, n_new, k=k, draft_layers=layers)(
            jt.shard_params(jp, jcfg, jmesh), prompt))
    mesh = make_mesh((1, tp), ("dp", "tp"), devices=["cpu"] * tp)
    toks, fwd = ts.make_speculative(tcfg, mesh, Tp, n_new, k=k,
                                    draft_layers=layers)(
        tt.shard_params(tparams, tcfg, mesh), prompt)
    assert toks.spec == P() and toks.shape == (1, n_new)
    for r in range(tp):
        assert torch.equal(toks.local(r), toks.local(0)), r
    np.testing.assert_array_equal(toks.gather().numpy(), packed[None, :n_new])
    assert fwd == int(packed[n_new])
    want, want_fwd = ts.generate_speculative_dense(
        tparams, prompt, n_new, tcfg, k=k, draft_layers=layers, device="cpu")
    assert torch.equal(toks.gather(), want) and fwd == want_fwd


def test_sharded_speculative_rejects_dp_moe_and_bad_shapes():
    """tests/test_speculative.py:112 and :121, and the reference's shape
    checks; a prompt of another length than made for raises."""
    cfg = tt.TransformerConfig(**CFG)
    with pytest.raises(ValueError, match="per-stream"):
        ts.make_speculative(cfg, make_mesh((2, 2), ("dp", "tp"),
                                           devices=["cpu"] * 4), 8, 4)
    moe = dataclasses.replace(cfg, n_experts=2)
    with pytest.raises(ValueError, match="dense configs only"):
        ts.make_speculative(moe, make_mesh((1, 2, 2), ("dp", "ep", "tp"),
                                           devices=["cpu"] * 4), 8, 4)
    mesh = make_mesh((1, 2), ("dp", "tp"), devices=["cpu"] * 2)
    for args in ((1, 4), (8, 0), (8, 4, 0)):
        with pytest.raises(ValueError, match="need Tp >= 2"):
            ts.make_speculative(cfg, mesh, *args[:2],
                                k=args[2] if len(args) > 2 else 4)
    with pytest.raises(ValueError, match="draft_layers"):
        ts.make_speculative(cfg, mesh, 8, 4, draft_layers=2)
    run = ts.make_speculative(cfg, mesh, 8, 5)
    params = tt.shard_params(tt.init_params(cfg, device="cpu"), cfg, mesh)
    with pytest.raises(ValueError, match="made for a"):
        run(params, _prompt(61, 6, 0))


def test_dryrun_multichip_on_eight_cpu_ranks(capsys):
    """The port's dry run: every leg of the reference's
    ``dryrun_multichip(8)`` against its oracle, and the summary line
    that MULTICHIP_r05.json records. The rateless leg's shard count
    follows the workers' arrival order (7 or 8 of them, run to run, in
    either package), so the line is compared with it masked, and its
    generation must be at least 1."""
    import json
    import pathlib
    import re

    from mpistragglers_jl_tpu_torch.parallel import dryrun_multichip

    dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    record = json.loads((pathlib.Path(__file__).parents[1]
                         / "MULTICHIP_r05.json").read_text())
    assert out[0].startswith("sim smoke: 50 virtual epochs")
    shards = r"rateless epoch \(gen (\d+), \d+/4 shards\)"
    assert int(re.search(shards, out[-1]).group(1)) >= 1
    assert re.sub(shards, "rateless", out[-1]) == re.sub(
        shards, "rateless", record["tail"].strip())
