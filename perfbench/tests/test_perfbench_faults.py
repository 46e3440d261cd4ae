"""Each fault a cell can have, planted under a tiny run on the CPU, makes
``correct`` come out false (the harness's look for a card is skipped)."""
from __future__ import annotations

import torch

from perfbench.tests import tiny

SERVE = next(c for c in tiny.CELLS if c.startswith("retrieval."))
TRAIN = [c for c in tiny.CELLS if c.startswith("paper.")]


def test_sound_runs_are_correct():
    for name in (SERVE, *TRAIN):
        assert tiny.run(name)["correct"]


def test_serve_answer_altered(monkeypatch):
    from repro_torch.index import search as isearch

    real = isearch.scan_topk

    def altered(index, scan, k):
        res = real(index, scan, k)
        ids = res.ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % index.capacity
        return res._replace(ids=ids)

    monkeypatch.setattr(isearch, "scan_topk", altered)
    assert not tiny.run(SERVE)["correct"]


def test_serve_half_the_batch_left_out(monkeypatch):
    from repro_torch.search import engine

    real = engine.Engine.submit

    def half(self, Q, **kw):
        b = Q.shape[0]
        p = real(self, Q[:b // 2], **kw)
        r = p.res
        twice = type(r)(*(torch.cat([x, x])[:b] for x in r))
        return p._replace(res=twice, batch=b)

    monkeypatch.setattr(engine.Engine, "submit", half)
    assert not tiny.run(SERVE)["correct"]


def test_serve_answer_left_unchanged(monkeypatch):
    """The state of a serving loop is its last answer: a batch that returns
    the previous batch's answer."""
    from repro_torch.search import engine

    real = engine.Engine.collect
    last = {}

    def stale(self, pending):
        res = real(self, pending)
        prev = last.get("res", res)
        last["res"] = res
        return prev

    monkeypatch.setattr(engine.Engine, "collect", stale)
    assert not tiny.run(SERVE)["correct"]


def test_train_state_left_unchanged(monkeypatch):
    from repro_torch.training import optimizer

    def unchanged(grads, state, params, cfg, generator=None, marks=None):
        return params, state, {}

    monkeypatch.setattr(optimizer, "update_with_deltas", unchanged)
    for name in TRAIN:
        assert not tiny.run(name)["correct"]


def test_train_half_the_batch_left_out(monkeypatch):
    from repro_torch.models import recsys

    real = recsys.twotower_loss

    def half(p, h, pos, cfg, use_index=True):
        b = h.shape[0] // 2
        return real(p, h[:b], pos[:b], cfg, use_index=use_index)

    monkeypatch.setattr(recsys, "twotower_loss", half)
    for name in TRAIN:
        assert not tiny.run(name)["correct"]


def test_train_answer_altered(monkeypatch):
    from repro_torch.models import recsys

    real = recsys.twotower_loss

    def altered(p, h, pos, cfg, use_index=True):
        return real(p, h, pos, cfg, use_index=use_index) * 1.01

    monkeypatch.setattr(recsys, "twotower_loss", altered)
    for name in TRAIN:
        assert not tiny.run(name)["correct"]
