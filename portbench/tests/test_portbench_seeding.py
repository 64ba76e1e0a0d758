"""The generator: one seed, one set of inputs and stalls."""

from __future__ import annotations

import numpy as np
import torch

from portbench import generator

SEED = 2 ** 31 + 12345  # past 32 signed bits: seeds may be that large


def test_operands_repeat_for_one_seed_and_move_with_it():
    a = generator.operands(6, 5, 4, 4, SEED, "cpu")
    b = generator.operands(6, 5, 4, 4, SEED, "cpu")
    c = generator.operands(6, 5, 4, 4, SEED + 1, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    A, B, v = a
    assert A.shape == (6, 5) and B.shape == (4, 5, 4) and v.shape == (4,)
    # four distinct payloads: no two epochs in a row multiply the same
    for p in range(4):
        assert not torch.equal(B[p], B[(p + 1) % 4])


def test_config_stragglers_stall_every_task():
    cfg = {"stragglers": [2, 5], "straggler_stall_s": 1.0}
    t = generator.stall_table({"stragglers": "config"}, cfg, 8, SEED)
    assert t.shape == (8, 1)
    assert t[:, 0].tolist() == [0, 0, 1.0, 0, 0, 1.0, 0, 0]
    assert np.array_equal(
        t, generator.stall_table({"stragglers": "config"}, cfg, 8, 7))


def test_exponential_stalls_repeat_for_one_seed_and_move_with_it():
    stall = {"stragglers": [1], "stall_s": 0.5, "exp_mean_s": 0.0035}
    a = generator.stall_table(stall, {}, 8, SEED)
    b = generator.stall_table(stall, {}, 8, SEED)
    c = generator.stall_table(stall, {}, 8, SEED + 1)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (8, generator.EXP_DRAWS)
    exp = np.delete(a, 1, axis=0)
    # independent draws of the exponential: its mean, and its tail
    # (P(x > 5 mean) = e^-5, so about 1,500 of 229,376 draws lie there)
    assert abs(exp.mean() - 0.0035) < 0.0035 * 0.01
    assert 1200 < (exp > 5 * 0.0035).sum() < 1900
    assert exp.max() > 10 * 0.0035
    # the straggler's fixed stall under its own draw
    assert np.allclose(a[1] - 0.5, c[1] - 0.5, atol=1.0)
    assert (a[1] >= 0.5).all()


def test_stall_gate_walks_each_workers_row_and_releases():
    table = np.array([[0.0, 0.0], [0.0, 30.0]])
    gate = generator.StallGate(table)
    assert gate(0, 1) == 0.0 and gate(0, 2) == 0.0 and gate(0, 3) == 0.0
    assert gate.calls == [3, 0]
    assert gate(1, 1) == 0.0  # row 1, task 0: no stall
    gate.release()
    assert gate(1, 2) == 0.0  # the 30 s stall, released: returns at once


def test_reservoir_repeats_for_one_seed():
    def draw(seed):
        r = generator.Reservoir(4, seed)
        for i in range(200):
            r.slot(i)
        return r.epochs

    assert draw(SEED) == draw(SEED)
    assert draw(SEED) != draw(SEED + 1)
    assert len(set(draw(SEED))) == 4
