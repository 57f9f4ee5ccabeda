"""The one traffic generator: endless seeded records from a mix's data file.

A record is (id, seqA, seqB, strA, strB).  The mix's ``records`` entry
names a kind and its parameters; the kind is the file
``records/<kind>.py``, found by name, whose ``records(spec, config, seed,
root)`` yields them.  The same seed gives the same records; the program
receives only these strings.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

from .reference.tables import read_cfssp

BLOCK = 4096


def load_file(root, folder, name):
    """The module ``portbench/<folder>/<name>.py`` under ``root``."""
    path = Path(root) / "portbench" / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {name!r} in portbench/{folder}: {path}")
    key = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{key}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rng_of(seed, stream=0):
    """A numpy generator from any whole number (a negative one too)."""
    seed = int(seed)
    return np.random.default_rng([seed & (2**64 - 1), (seed >> 64) & 1,
                                  int(seed < 0), stream])


def spread(k):
    """The k-th share of a range in the order 0.5, 0, 1, 0.25, 0.75, ...
    (van der Corput, base 2)."""
    if k < 3:
        return (0.5, 0.0, 1.0)[k]
    k -= 1
    out, f = 0.0, 0.5
    while k:
        out += f * (k & 1)
        k >>= 1
        f /= 2
    return out


def base_pair(config, root):
    """(seqA, strA, seqB, strB) of the configuration's data files."""
    files = config["data"]["pair"]
    seqA, strA = read_cfssp(Path(root) / files[0])
    seqB, strB = read_cfssp(Path(root) / files[1])
    return seqA, strA, seqB, strB


def substitute(rng, seq, share, alphabet):
    """``seq`` with a share of its letters replaced, each by another letter
    of ``alphabet`` drawn uniformly (any letter where the old one is not in
    it)."""
    chars = np.frombuffer(seq.encode("ascii"), np.uint8).copy()
    alpha = np.frombuffer(alphabet.encode("ascii"), np.uint8)
    hit = np.flatnonzero(rng.random(len(chars)) < share)
    lut = np.full(256, -1, np.int64)
    lut[alpha] = np.arange(len(alpha))
    idx = lut[chars[hit]]
    k = rng.integers(len(alpha) - (idx >= 0))
    k = k + ((idx >= 0) & (k >= idx))
    chars[hit] = alpha[k]
    return chars.tobytes().decode("ascii")


def records(config, mix, seed, root):
    """Endless iterator of the mix's records for ``seed``."""
    spec = mix["records"]
    return load_file(root, "records", spec["kind"]).records(
        spec, config, seed, root)
