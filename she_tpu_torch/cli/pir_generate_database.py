"""PIRGenerateDatabase: synthesize a keyword-value test database
(reference Sources/PIRGenerateDatabase/main.swift:21-120).

Writes she_tpu's bytes: the values are the draws of random.Random(0) that
she_tpu's tool makes (rng.randint(lo, hi) for a row's size, then
rng.randrange(256) for each byte), taken here from a numpy MT19937 put in
the same state, so a million rows take seconds, not a Python call a byte.
Host code: it takes no --device.
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np

from ..io import pb
from . import util

WORDS_PER_DRAW = 1 << 20


class MersenneWords:
    """The 32-bit outputs of a random.Random, read in bulk.

    random.Random.getrandbits(k) for k <= 32 takes one 32-bit output w of
    its MT19937 and returns w >> (32 - k); randrange(n) (and randint) draws
    getrandbits(n.bit_length()) until the value is below n. numpy's MT19937
    in the same state gives the same outputs (random_raw)."""

    def __init__(self, rng: random.Random):
        state = rng.getstate()[1]
        self._mt = np.random.MT19937()
        self._mt.state = {"bit_generator": "MT19937",
                          "state": {"key": np.array(state[:624], dtype=np.uint32), "pos": state[624]}}
        self._words = np.zeros(0, dtype=np.uint64)
        self._pos = 0

    def _ensure(self, count: int) -> None:
        if self._pos + count > len(self._words):
            more = self._mt.random_raw(max(count, WORDS_PER_DRAW))
            self._words = np.concatenate((self._words[self._pos :], more))
            self._pos = 0

    def below(self, n: int) -> int:
        """random.Random.randrange(n) for n >= 1."""
        shift = np.uint64(32 - n.bit_length())
        while True:
            self._ensure(1)
            r = int(self._words[self._pos] >> shift)
            self._pos += 1
            if r < n:
                return r

    def bytes_below_256(self, count: int) -> bytes:
        """bytes(randrange(256) for _ in range(count)): 9-bit draws, those
        below 256 kept, each draw one output."""
        want = 2 * count + 64
        while True:
            self._ensure(want)
            draws = self._words[self._pos : self._pos + want] >> np.uint64(23)
            kept = np.flatnonzero(draws < 256)
            if len(kept) >= count:
                break
            want *= 2
        if count == 0:
            return b""
        self._pos += int(kept[count - 1]) + 1
        return draws[kept[:count]].astype(np.uint8).tobytes()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate a keyword PIR test database")
    parser.add_argument("--output-database", required=True, help=".binpb/.txtpb output")
    parser.add_argument("--row-count", type=int, required=True)
    parser.add_argument("--value-size", required=True, help="fixed size or 'min..max' range")
    parser.add_argument(
        "--value-type",
        choices=["random", "repeated"],
        default="random",
        help="random bytes or the keyword repeated",
    )
    parser.add_argument("--first-keyword", type=int, default=0)
    args = parser.parse_args(argv)

    if ".." in args.value_size:
        lo, hi = (int(v) for v in args.value_size.split(".."))
    else:
        lo = hi = int(args.value_size)
    words = MersenneWords(random.Random(0))
    db = pb.pir_pb2.KeywordDatabase()
    for i in range(args.first_keyword, args.first_keyword + args.row_count):
        row = db.rows.add()
        keyword = str(i).encode()
        row.keyword = keyword
        size = lo + words.below(hi - lo + 1)
        if args.value_type == "random":
            row.value = words.bytes_below_256(size)
        else:
            row.value = (keyword * (size // max(len(keyword), 1) + 1))[:size]
    util.save_proto(args.output_database, db)
    print(f"Wrote {args.row_count} rows to {args.output_database}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
