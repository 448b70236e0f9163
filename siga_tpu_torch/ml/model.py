"""Edge-classification models for AIVisitor.

The reference loads mlpack bagged decision trees (src/mlpack.h:19-78,
HAVE_MLPACK).  Here models are JSON: a list of trees, each with flat arrays
(feature, threshold, left, right, label) where leaves have left == -1.
`classify` returns the number of trees voting class 1 (matching the reference
semantics: 0 votes -> remove edge, > size/2 -> keep,
src/bigraph_visitors.cpp:1414-1428).  Batched inference runs all trees over
all feature rows vectorized in numpy; train_bagging fits a simple bagged
CART ensemble so models can be produced without external deps.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np


class BaggingModel:
    def __init__(self, trees: List[dict]):
        self.trees = [
            {
                "feature": np.asarray(t["feature"], dtype=np.int64),
                "threshold": np.asarray(t["threshold"], dtype=np.float64),
                "left": np.asarray(t["left"], dtype=np.int64),
                "right": np.asarray(t["right"], dtype=np.int64),
                "label": np.asarray(t["label"], dtype=np.int64),
            }
            for t in trees
        ]

    @property
    def size(self) -> int:
        return len(self.trees)

    @classmethod
    def load(cls, path: str) -> "BaggingModel":
        with open(path) as f:
            return cls(json.load(f)["trees"])

    def save(self, path: str) -> None:
        out = {
            "trees": [
                {k: v.tolist() for k, v in t.items()} for t in self.trees
            ]
        }
        with open(path, "w") as f:
            json.dump(out, f)

    def classify(self, features: Sequence[float]) -> int:
        return int(self.classify_batch(np.asarray(features)[None, :])[0])

    def classify_batch(self, x: np.ndarray) -> np.ndarray:
        """x: (B, F) -> votes for class 1 per row, int array (B,)."""
        votes = np.zeros(x.shape[0], dtype=np.int64)
        for t in self.trees:
            node = np.zeros(x.shape[0], dtype=np.int64)
            # trees are finite; max depth bounded by node count
            for _ in range(len(t["feature"])):
                leaf = t["left"][node] == -1
                if leaf.all():
                    break
                feat = t["feature"][node]
                go_left = x[np.arange(x.shape[0]), feat] <= t["threshold"][node]
                nxt = np.where(go_left, t["left"][node], t["right"][node])
                node = np.where(leaf, node, nxt)
            votes += t["label"][node] == 1
        return votes


def _fit_tree(x, y, rng, max_depth=6, min_leaf=4):
    feature, threshold, left, right, label = [], [], [], [], []

    def build(idx, depth):
        node = len(feature)
        feature.append(0)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        label.append(int(round(y[idx].mean())) if len(idx) else 0)
        if depth >= max_depth or len(idx) < 2 * min_leaf or len(set(y[idx])) == 1:
            return node
        best = None
        for f in rng.choice(x.shape[1], size=max(1, x.shape[1] // 3), replace=False):
            vals = x[idx, f]
            for q in (0.25, 0.5, 0.75):
                thr = float(np.quantile(vals, q))
                lm = vals <= thr
                nl, nr = int(lm.sum()), int((~lm).sum())
                if nl < min_leaf or nr < min_leaf:
                    continue
                pl = y[idx][lm].mean()
                pr = y[idx][~lm].mean()
                gini = nl * pl * (1 - pl) + nr * pr * (1 - pr)
                if best is None or gini < best[0]:
                    best = (gini, int(f), thr, lm)
        if best is None:
            return node
        _g, f, thr, lm = best
        feature[node] = f
        threshold[node] = thr
        left[node] = build(idx[lm], depth + 1)
        right[node] = build(idx[~lm], depth + 1)
        return node

    build(np.arange(len(y)), 0)
    return {
        "feature": feature,
        "threshold": threshold,
        "left": left,
        "right": right,
        "label": label,
    }


def train_bagging(
    x: np.ndarray, y: np.ndarray, n_trees: int = 15, seed: int = 0
) -> BaggingModel:
    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(n_trees):
        idx = rng.integers(0, len(y), len(y))
        trees.append(_fit_tree(x[idx], y[idx], rng))
    return BaggingModel(trees)
