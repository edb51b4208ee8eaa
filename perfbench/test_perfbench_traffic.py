"""The traffic generator: its batches are a function of the seed alone,
and every seed gives the same sizes."""
import numpy as np
import pytest

from pbench import spec, traffic

MIXES = sorted(p.stem for p in (spec.BENCH_DIR / "traffic").glob("*.json"))


def _small(name):
    mix = spec.load_json(spec.BENCH_DIR / "traffic" / f"{name}.json")
    return dict(mix, seq_len=min(mix["seq_len"], 512), batches=3)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_batches_and_sizes(name):
    mix = _small(name)
    seed = 2**31 + 11
    a = traffic.batches(mix, 50304, seed)
    b = traffic.batches(mix, 50304, seed)
    c = traffic.batches(mix, 50304, seed + 1)
    assert len(a) == mix["batches"]
    for x, y, z in zip(a, b, c):
        assert x.dtype == np.int32
        assert x.shape == z.shape == (mix["rows"], mix["seq_len"])
        assert np.array_equal(x, y)
        assert not np.array_equal(x, z)
        assert x.min() >= 1 and x.max() < 50304
    assert not np.array_equal(a[0], a[1])


def test_rows_hold_packed_documents_with_separators():
    mix = dict(_small("packed.8x2048"), mean_doc_len=16)
    rows = traffic.batches(mix, 512, 5)[0]
    assert (rows == mix["eos"]).sum() >= rows.shape[0]
    assert set(np.unique(rows)) <= set(range(1, 512))


def test_tokens_per_step():
    assert traffic.tokens_per_step({"rows": 8, "seq_len": 2048}) == 16384
