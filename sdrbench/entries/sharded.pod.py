"""Entry of the pod cell, ``pod_bank.custom.x4``: ``entries/sharded.py``'s
``Entry`` as it stands, one rank a card over the configuration's (channel,
time) mesh. Called without ranks, in one process, as a caller that runs
every cell in one process does (the harness's module check on the CPU),
the mesh is that process's own, 1 x 1: the same sharded dispatch, state cut
and gather, with no collective. ``python3 -m sdrbench.run`` always runs
this cell over its ranks."""

from __future__ import annotations

from types import SimpleNamespace

from sdrbench import spec

_sharded = spec.load_module("entries", "sharded")


def build(cfg: dict, traffic: dict, designs, device, ranks=None):
    if ranks is None:
        cfg, ranks = dict(cfg, mesh={"channel": 1, "time": 1}), SimpleNamespace(world=1)
    return _sharded.Entry(cfg, traffic, designs, device, ranks)
