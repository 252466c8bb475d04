"""Heterogeneous tensors, schema detection, transformencode: the port's
`repro_torch.core.hetero` against the reference's `repro.core.hetero`.
Mirrors tests/test_hetero.py; every output is held bitwise (array dtype,
shape and bytes), and every `TransformMeta` field equal, to the
reference's on the same inputs."""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.core import hetero as R
from repro_torch.core import hetero as T

PKGS = {"ref": R, "port": T}


def same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == object:
        assert a.tolist() == b.tolist()
    else:
        assert a.tobytes() == b.tobytes()


def same_dt(a, b):
    assert a.names == b.names and a.types == b.types
    assert len(a.columns) == len(b.columns)
    for ca, cb in zip(a.columns, b.columns):
        same_array(ca, cb)


def same_meta(a, b):
    assert a.spec == b.spec and a.out_names == b.out_names
    assert a.recode_maps == b.recode_maps
    assert a.centers == b.centers and a.scales == b.scales
    assert a.bins.keys() == b.bins.keys()
    for k in a.bins:
        same_array(a.bins[k], b.bins[k])


def both(fn):
    """fn(module) through each package."""
    return fn(R), fn(T)


class TestSchemaDetection:
    @pytest.mark.parametrize("col,want", [
        (["1", "2", "3"], "i32"), (["1.5", "2"], "f64"),
        (["true", "false"], "bool"), (["a", "b"], "str"),
        ([str(2 ** 40)], "i64"), (["", "7"], "i32"), ([], "str")])
    def test_types(self, col, want):
        r, t = both(lambda m: m.detect_value_type(np.array(col, object)))
        assert r == t == want

    def test_from_frame(self):
        frame = np.array([["1", "2.5", "x", "true"],
                          ["2", "", "y", "false"]], dtype=object)
        r, t = both(lambda m: m.DataTensor.from_frame(frame))
        same_dt(r, t)
        assert t.types == ["i32", "f64", "str", "bool"]
        assert t.shape == (2, 4)


class TestDataTensor:
    @staticmethod
    def _dt(m):
        return m.DataTensor.from_dict({
            "age": [25, 30, 45, 22],
            "income": [50.0, 60.5, 80.0, 45.0],
            "city": np.array(["a", "b", "a", "c"], dtype=object),
            "flag": np.array([True, False, True, True]),
            "n32": np.arange(4, dtype=np.int32),
            "f32": np.arange(4, dtype=np.float32),
        }, types={"city": "str"})

    def test_schema(self):
        r, t = both(self._dt)
        same_dt(r, t)
        assert t.schema == r.schema
        assert t.schema[:3] == [("age", "i64"), ("income", "f64"),
                                ("city", "str")]

    def test_select_rows(self):
        r, t = both(lambda m: self._dt(m).select_rows(np.array([0, 2])))
        same_dt(r, t)
        assert t.nrows == 2 and t.column("age").tolist() == [25, 45]

    def test_numeric_matrix(self):
        r, t = both(lambda m: self._dt(m).numeric_matrix())
        same_array(r, t)
        assert t.shape == (4, 5)


class TestTransformEncode:
    def test_recode_dummycode_scale(self):
        def enc(m):
            dt = m.DataTensor.from_dict({
                "cat": np.array(["a", "b", "a", "c"], dtype=object),
                "num": [1.0, 2.0, 3.0, 4.0],
            }, types={"cat": "str"})
            return m.transformencode(dt, {"cat": "dummycode",
                                          "num": "scale"})
        (xr, mr), (xt, mt) = both(enc)
        same_array(xr, xt)
        same_meta(mr, mt)
        assert xt.shape == (4, 4)

    def test_apply_matches_encode(self):
        def enc(m):
            dt = m.DataTensor.from_dict({
                "cat": np.array(["a", "b", "a"], dtype=object),
                "num": [1.0, 2.0, 3.0]}, types={"cat": "str"})
            x, meta = m.transformencode(dt, {"cat": "recode",
                                             "num": "scale"})
            return x, m.transformapply(dt, meta), meta
        (xr, ar, mr), (xt, at, mt) = both(enc)
        same_array(xr, xt)
        same_array(ar, at)
        same_array(xt, at)
        same_meta(mr, mt)

    @pytest.mark.parametrize("how", ["bin:4", "bin", "drop", "passthrough"])
    def test_binning_drop_passthrough(self, how):
        def enc(m):
            v = np.arange(100.0)
            v[::7] = np.nan
            dt = m.DataTensor.from_dict({"v": v, "w": np.arange(100) % 3})
            return m.transformencode(dt, {"v": how})
        (xr, mr), (xt, mt) = both(enc)
        same_array(xr, xt)
        same_meta(mr, mt)

    def test_unseen_category_apply(self):
        def enc(m):
            dt = m.DataTensor.from_dict({"c": np.array(["a", "b"], object)},
                                        types={"c": "str"})
            _, meta = m.transformencode(dt, {"c": "dummycode"})
            dt2 = m.DataTensor.from_dict({"c": np.array(["z"], object)},
                                         types={"c": "str"})
            return m.transformapply(dt2, meta)
        r, t = both(enc)
        same_array(r, t)
        assert t.sum() == 0.0

    def test_string_passthrough_raises(self):
        for m in (R, T):
            dt = m.DataTensor.from_dict({"c": np.array(["a"], object)},
                                        types={"c": "str"})
            with pytest.raises(ValueError, match="needs an encoder"):
                m.transformencode(dt, {})


class TestBlocking:
    @pytest.mark.parametrize("rank", [1, 2, 3, 4, 5, 6, 7])
    def test_block_shapes_scheme(self, rank):
        assert T.block_shape(rank) == R.block_shape(rank)

    def test_unsupported_rank(self):
        with pytest.raises(ValueError, match="unsupported rank"):
            T.block_shape(8)

    def test_reblock_matches_reference(self):
        arr = np.arange(300 * 260, dtype=np.float32).reshape(300, 260)
        r, t = both(lambda m: m.reblock(arr, target_rank=3))
        assert list(r) == list(t)
        for k in r:
            same_array(r[k], t[k])
        assert len(t) == 9 and t[(2, 2)].shape == (44, 4)


@settings(max_examples=5, deadline=None)
@given(st.integers(1, 50), st.integers(0, 10 ** 6))
def test_roundtrip_property(nrows, seed):
    def enc(m):
        rng = np.random.default_rng(seed)
        dt = m.DataTensor.from_dict({
            "a": rng.integers(0, 5, nrows),
            "b": rng.normal(size=nrows),
            "c": np.array([f"s{v}" for v in rng.integers(0, 3, nrows)],
                          object),
        }, types={"c": "str"})
        x, meta = m.transformencode(dt, {"a": "passthrough", "b": "scale",
                                         "c": "recode"})
        return x, m.transformapply(dt, meta), meta
    (xr, ar, mr), (xt, at, mt) = both(enc)
    same_array(xr, xt)
    same_array(at, xt)
    same_meta(mr, mt)
    assert xt.shape[0] == nrows
