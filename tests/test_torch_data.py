"""Ingestion and synthetic data: the port's `repro_torch.data` against the
reference's `repro.data` on the same files and seeds. `read_csv_chunks`
equals `read_csv` over ragged byte windows (mirrors the CSV half of
tests/test_streaming.py), the generated reader reads the reference's
columns, and every generator, the token pipeline and the modality stubs
are bitwise the reference's."""
import numpy as np
import pytest

from repro.data import csv_io as rcsv
from repro.data import frontends as rfe
from repro.data import synthetic as rsyn
from repro.data.tokens import TokenPipeline as RPipe
from repro_torch.data import csv_io as tcsv
from repro_torch.data import frontends as tfe
from repro_torch.data import synthetic as tsyn
from repro_torch.data.tokens import TokenPipeline as TPipe


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.fixture
def csv_file(rng, tmp_path):
    x = rng.normal(size=(1000, 5))
    path = str(tmp_path / "x.csv")
    nbytes = tcsv.write_csv(path, x, fmt="%.17g")
    ref_path = str(tmp_path / "r.csv")
    assert rcsv.write_csv(ref_path, x, fmt="%.17g") == nbytes
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    return path, x


def test_read_csv_chunks_matches_read_csv(csv_file):
    path, x = csv_file
    full = tcsv.read_csv(path)
    same(full, rcsv.read_csv(path))
    np.testing.assert_array_equal(full, x)    # %.17g round-trips float64
    parts = list(tcsv.read_csv_chunks(path, 128, chunk_bytes=4096))
    assert [off for off, _ in parts] == list(range(0, 1000, 128))
    assert all(a.shape[0] == 128 for _, a in parts[:-1])
    assert parts[-1][1].shape[0] == 1000 - 128 * 7
    same(np.vstack([a for _, a in parts]), full)


@pytest.mark.parametrize("rows,window", [(1, 97), (64, 1 << 12),
                                         (333, 1500), (5000, 1 << 20)])
def test_chunks_match_the_reference(csv_file, rows, window):
    """Ragged byte windows (a window smaller than a line, windows that
    split lines anywhere) give the reference's chunks, bit for bit."""
    path, _ = csv_file
    got = list(tcsv.read_csv_chunks(path, rows, chunk_bytes=window))
    want = list(rcsv.read_csv_chunks(path, rows, chunk_bytes=window))
    assert [o for o, _ in got] == [o for o, _ in want]
    for (_, a), (_, b) in zip(got, want):
        same(a, b)


def test_rows_per_chunk_validated(csv_file):
    with pytest.raises(ValueError, match="rows_per_chunk"):
        next(tcsv.read_csv_chunks(csv_file[0], 0))


def test_unterminated_last_line(tmp_path):
    path = str(tmp_path / "t.csv")
    with open(path, "w") as f:
        f.write("1,2\n3,4\n5,6")
    for mod in (tcsv, rcsv):
        same(mod.read_csv(path), np.array([[1, 2], [3, 4], [5, 6]], float))
    got = list(tcsv.read_csv_chunks(path, 2, chunk_bytes=5))
    want = list(rcsv.read_csv_chunks(path, 2, chunk_bytes=5))
    for (o1, a), (o2, b) in zip(got, want, strict=True):
        assert o1 == o2
        same(a, b)


DESC = {"delimiter": ",", "columns": [
    ("age", "f64"), ("n", "i64"), ("region", "str"), ("score", "f64")]}


def test_generated_reader_matches_the_reference(tmp_path, rng):
    path = str(tmp_path / "h.csv")
    regions = np.array(["north", "south", "east", "west"])
    with open(path, "w") as f:
        for i in range(400):
            f.write(f"{rng.integers(18, 80)},{i},"
                    f"{regions[rng.integers(0, 4)]},{rng.normal():.4f}\n")
    desc = dict(DESC, chunk_bytes=1500)
    treader, rreader = tcsv.make_reader(desc), rcsv.make_reader(desc)
    got, want = treader(path), rreader(path)
    assert list(got) == list(want) == ["age", "n", "region", "score"]
    for k in got:
        same(got[k], want[k])
    assert treader.__source__ == rreader.__source__.replace(
        "repro.data.csv_io", "repro_torch.data.csv_io")


@pytest.mark.parametrize("kw", [dict(), dict(sparsity=0.3, noise=0.5,
                                             seed=3)])
def test_gen_regression_bitwise(kw):
    for a, b in zip(tsyn.gen_regression(50, 7, **kw),
                    rsyn.gen_regression(50, 7, **kw), strict=True):
        same(a, b)


@pytest.mark.parametrize("n_codebooks", [0, 4])
def test_gen_tokens_bitwise(n_codebooks):
    same(tsyn.gen_tokens(300, 97, seed=5, n_codebooks=n_codebooks),
         rsyn.gen_tokens(300, 97, seed=5, n_codebooks=n_codebooks))


@pytest.mark.parametrize("n_codebooks", [0, 2])
def test_token_pipeline_batches_and_restore(n_codebooks):
    kw = dict(vocab=101, batch=3, seq_len=9, seed=7, shard=1, n_shards=2,
              n_codebooks=n_codebooks)
    tp, rp = TPipe(**kw), RPipe(**kw)
    for step in (0, 1, 17):
        got, want = tp.batch_at(step), rp.batch_at(step)
        assert list(got) == list(want) == ["tokens", "labels"]
        for k in got:
            same(got[k], want[k])
    it = iter(tp)
    next(it), next(it)
    assert tp.state() == {"seed": 7, "shard": 1, "step": 1}
    restored = TPipe.restore(tp.state(), vocab=101, batch=3, seq_len=9,
                             n_codebooks=n_codebooks)
    want = RPipe.restore(tp.state(), vocab=101, batch=3, seq_len=9,
                         n_codebooks=n_codebooks)
    for k in ("tokens", "labels"):
        same(next(iter(restored))[k], next(iter(want))[k])


def test_frontends_bitwise():
    same(tfe.vision_embeddings(2, 5, 16, seed=3),
         rfe.vision_embeddings(2, 5, 16, seed=3))
    same(tfe.encodec_tokens(2, 12, 50, n_books=4, seed=1),
         rfe.encodec_tokens(2, 12, 50, n_books=4, seed=1))


def test_package_exports():
    import repro_torch.data as D
    assert D.gen_regression is tsyn.gen_regression
    assert D.TokenPipeline is TPipe
