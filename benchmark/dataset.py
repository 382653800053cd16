"""The train split of the configuration's interaction graph, made by the
benchmark's own generator (``benchmark/data/synthetic.py``).

The graph stands for the data set, so it does not change with ``--seed``: a
configuration's ``graph`` block fixes its sizes and its own seed. It is
written once per checkout under ``benchmark/.cache/data/`` (about 150 MB at
ML-25M's size) and read back by every later run, as a deployment reads its
data set from disk.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from benchmark.data import synthetic
from benchmark.harness import Context


#: what a cache file holds; a new layout is a new key
LAYOUT = ("num_users", "num_items", "train")


def _key(config: dict) -> str:
    spec = json.dumps({"graph": config["graph"], "split": config["split"],
                       "layout": LAYOUT}, sort_keys=True)
    return hashlib.sha256(spec.encode()).hexdigest()[:16]


def build(config: dict) -> dict:
    g = config["graph"]
    num_users, num_items, edges = synthetic.make_graph(
        g["users"], g["items"], g["interactions"], seed=g["seed"], power=g["power"],
        num_communities=g["communities"])
    split = config["split"]
    if split == "edge":
        train, _, _ = synthetic.split_edges(edges)
    elif split == "interaction":
        train, _, _ = synthetic.split_interactions(edges, num_users)
    else:
        raise ValueError(f"unknown split {split!r}")
    return {"num_users": num_users, "num_items": num_items, "train": train}


def load(ctx: Context) -> dict:
    key = _key(ctx.config)
    if key in ctx.cache:
        return ctx.cache[key]
    path = ctx.root / ".cache" / "data" / f"{key}.npz"
    with ctx.spans("setup.data"):
        if path.is_file():
            with np.load(path) as z:
                data = {k: z[k] for k in LAYOUT}
                data["num_users"], data["num_items"] = (int(data["num_users"]),
                                                        int(data["num_items"]))
        else:
            data = build(ctx.config)
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
            with open(tmp, "wb") as f:
                np.savez(f, **data)
                f.flush()
                os.fsync(f.fileno())      # written back before the window opens
            os.replace(tmp, path)
    ctx.cache[key] = data
    return data
