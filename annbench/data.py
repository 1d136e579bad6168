"""The corpus and the query set of a cell.

A rewrite in numpy of the generator of ann-benchmarks' ``random-*`` data
sets (``ann_benchmarks/datasets.py``, ``random_float``): scikit-learn's
``make_blobs(n_samples, n_features, centers, random_state)`` (centres
uniform in ``center_box``, an equal share of the samples around each
centre with Gaussian noise of ``cluster_std``, the samples shuffled), then
``train_test_split(X, test_size, random_state)``.  It makes the same
numbers from the same legacy ``RandomState`` draws, so the corpus (the
train split) and the query set (the test split) are the published data
set's, made anew in every run and never downloaded.  Rows are served as
float32.

The run's seed orders the query set: every seed sends the same queries,
the data set's own, in an order of its own, so seeds change the order of
the work and never the work.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# numpy's Generator takes seeds of any size; whole numbers are masked to
# 64 bits so a negative one is valid too
_SEED_MASK = (1 << 64) - 1


def make_blobs(samples: int, dim: int, centers: int, cluster_std: float,
               center_box: Tuple[float, float], rng: np.random.RandomState
               ) -> np.ndarray:
    """scikit-learn's ``make_blobs`` with an integer number of centres and
    ``shuffle=True``: (samples, dim) float64."""
    c = rng.uniform(center_box[0], center_box[1], size=(centers, dim))
    per = [samples // centers] * centers
    for i in range(samples % centers):
        per[i] += 1
    x = np.empty((samples, dim))
    start = 0
    for i, n in enumerate(per):
        x[start:start + n] = rng.normal(loc=c[i], scale=cluster_std,
                                        size=(n, dim))
        start += n
    order = np.arange(samples)
    rng.shuffle(order)
    return x[order]


def train_test_split(x: np.ndarray, test: int, random_state: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """scikit-learn's ``train_test_split(x, test_size=test,
    random_state=random_state)`` without stratification."""
    perm = np.random.RandomState(random_state).permutation(len(x))
    return x[perm[test:]], x[perm[:test]]


def blobs(spec: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) float32 of a configuration's ``data`` entry."""
    state = int(spec["random_state"])
    x = make_blobs(int(spec["samples"]), int(spec["dimension"]),
                   int(spec["centers"]), float(spec["cluster_std"]),
                   tuple(spec["center_box"]), np.random.RandomState(state))
    train, test = train_test_split(x, int(spec["test_size"]), state)
    return train.astype(np.float32), test.astype(np.float32)


def make(config: dict, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A configuration's corpus and its query set in the order of
    `seed`."""
    spec = dict(config["data"], dimension=config["dimension"])
    corpus, queries = blobs(spec)
    if corpus.shape[0] != int(config["rows"]) or \
            queries.shape[0] != int(config["queries"]):
        raise ValueError("the data entry does not give the configuration's "
                         "rows and queries")
    order = np.random.default_rng(int(seed) & _SEED_MASK).permutation(
        len(queries))
    return corpus, np.ascontiguousarray(queries[order])
