"""The lifecycle slice end to end: `examples/lifecycle_pipeline.py`'s steps
(generated CSV reader, schema detection, outlier clipping and
imputation, transformencode, steplm, a 12-λ grid and 5-fold CV, both
sequential with reuse, a checkpoint with lineage) at the example's 4,000
rows through the reference and through the port on the CPU. Schema,
selected features and feature names equal; betas, losses and CV errors
within rtol 1e-9; reuse stats equal; the checkpoints' leaves and lineage
equal (floats within rtol 1e-9), and each package restores the other's.
"""
import importlib
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-9
COLUMNS = [("age", "f64"), ("income", "f64"), ("tenure", "f64"),
           ("region", "str"), ("score", "f64")]


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "lifecycle_example", ROOT / "examples" / "lifecycle_pipeline.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    path = tmp_path_factory.mktemp("life") / "customers.csv"
    example.synthesize_messy_csv(str(path))
    return str(path)


def run_pipeline(pkg: str, csv_path: str, ckpt_dir: str, **rt_kw) -> dict:
    """The example's steps through package `pkg`; `rt_kw` goes to every
    runtime (the port's `device="cpu"`)."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    core, hetero = mod("core"), mod("core.hetero")
    life, validation = mod("lifecycle"), mod("lifecycle.validation")
    store = mod("checkpoint.store")
    cols = mod("data.csv_io").make_reader(
        {"delimiter": ",", "columns": COLUMNS})(csv_path)
    dt = hetero.DataTensor.from_dict(
        {k: cols[k] for k in ("age", "income", "tenure", "region")},
        types={"region": "str"})
    clean_rt = core.LineageRuntime(**rt_kw)
    x_num = life.outlier_by_iqr(core.input_tensor("Xraw", dt.numeric_matrix()),
                                k=3.0, repair="clip", runtime=clean_rt)
    x_num = life.impute_by_mean(core.input_tensor("Xclip", x_num),
                                runtime=clean_rt)
    for j, name in enumerate(("age", "income", "tenure")):
        dt.columns[dt.names.index(name)] = x_num[:, j]
    x, meta = hetero.transformencode(dt, {"age": "scale", "income": "scale",
                                          "tenure": "scale",
                                          "region": "dummycode"})
    y = cols["score"][:, None]
    rt = core.LineageRuntime(cache=core.ReuseCache(), **rt_kw)
    X, Y = core.input_tensor("X", x), core.input_tensor("y", y)
    beta_sel, selected = life.steplm(X, Y, max_features=5, runtime=rt)
    lambdas = np.logspace(-3, 2, 12).tolist()
    betas, losses = life.grid_search_lm(X, Y, lambdas, runtime=rt,
                                        mode="sequential")
    best = int(np.argmin(losses))
    fx, fy = validation.make_folds(x, y, 5, seed=0)
    _, cv_errs = life.cross_validate_lm(fx, fy, reg=lambdas[best],
                                        runtime=rt, mode="sequential")
    store.save(ckpt_dir, 0, {"beta": betas[:, best:best + 1]},
               lineage={"lambda": lambdas[best],
                        "features": meta.out_names,
                        "cv_mse": [float(e) for e in cv_errs]})
    return dict(schema=dt.schema, selected=selected, names=meta.out_names,
                x=x, beta_sel=beta_sel, betas=betas, losses=losses,
                cv_errs=np.asarray(cv_errs), reuse=rt.cache.stats.as_dict(),
                best=best)


@pytest.fixture(scope="module")
def runs(csv_path, tmp_path_factory):
    """Both packages' runs, both at pipeline depth 1; module-scoped, so
    the environment is set by hand."""
    d = tmp_path_factory.mktemp("ckpt")
    old = os.environ.get("REPRO_PIPELINE_DEPTH")
    os.environ["REPRO_PIPELINE_DEPTH"] = "1"
    try:
        ref = run_pipeline("repro", csv_path, str(d / "ref"))
        port = run_pipeline("repro_torch", csv_path, str(d / "port"),
                            device="cpu")
    finally:
        if old is None:
            os.environ.pop("REPRO_PIPELINE_DEPTH")
        else:
            os.environ["REPRO_PIPELINE_DEPTH"] = old
    return ref, port, d


def test_schema_features_and_names_equal(runs):
    ref, port, _ = runs
    assert port["schema"] == ref["schema"]
    assert port["names"] == ref["names"]
    assert port["selected"] == ref["selected"] and len(port["selected"]) == 5
    assert port["best"] == ref["best"]


@pytest.mark.parametrize("key", ["beta_sel", "betas", "losses", "cv_errs"])
def test_numbers_within_rtol(runs, key):
    ref, port, _ = runs
    np.testing.assert_allclose(port[key], ref[key], rtol=RTOL, atol=0)


def test_cleaned_features_within_rtol(runs):
    """The cleaned, encoded matrix over its largest entry (standardized
    columns have entries near 0, where elementwise rtol means nothing)."""
    ref, port, _ = runs
    err = np.abs(port["x"] - ref["x"]).max() / np.abs(ref["x"]).max()
    assert port["x"].shape == ref["x"].shape == (4000, 7) and err <= RTOL


def test_reuse_stats_equal(runs):
    ref, port, _ = runs
    assert port["reuse"] == ref["reuse"] and port["reuse"]["hits"] > 0


def test_checkpoints_equal_and_cross_restore(runs):
    from repro.checkpoint import store as rstore
    from repro_torch.checkpoint import store as tstore
    _, _, d = runs
    like_np = {"beta": np.zeros((7, 1))}
    r_tree, r_man = rstore.restore(str(d / "ref"), like_np)
    t_tree, t_man = tstore.restore(str(d / "port"), like_np)
    np.testing.assert_allclose(t_tree["beta"], r_tree["beta"], rtol=RTOL)
    assert t_man["leaves"] == r_man["leaves"]
    assert t_man["step"] == r_man["step"] == 0
    rl, tl = r_man["lineage"], t_man["lineage"]
    assert tl.keys() == rl.keys()
    assert tl["lambda"] == rl["lambda"] and tl["features"] == rl["features"]
    np.testing.assert_allclose(tl["cv_mse"], rl["cv_mse"], rtol=RTOL)
    # each package restores the other's checkpoint bit for bit
    back, _ = tstore.restore(str(d / "ref"),
                             {"beta": torch.zeros(7, 1, dtype=torch.float64)})
    assert back["beta"].numpy().tobytes() == \
        np.asarray(r_tree["beta"]).tobytes()
    back, _ = rstore.restore(str(d / "port"), like_np)
    assert np.asarray(back["beta"]).tobytes() == t_tree["beta"].tobytes()
