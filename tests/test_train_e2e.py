"""End-to-end trainer tests on synthetic data: learning, persistence, resume."""

import os

import numpy as np
import pytest

from one_class_ffm_tpu.data.synth import SynthSpec, write_dataset
from one_class_ffm_tpu.train import (
    TrainConfig,
    Trainer,
    load_checkpoint,
    load_text_model,
    save_text_model,
)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth")
    spec = SynthSpec(n_users=120, n_items=40, avg_pos=6.0, seed=3)
    return write_dataset(str(out), spec)


def make_cfg(dataset, tmp_path, **kw):
    item, train, va = dataset
    defaults = dict(
        item_path=item,
        train_path=train,
        test_path=va,
        k=4,
        lam=0.05,
        omega=0.1,
        nr_pass=6,
        eval_every=3,
        dtype="float64",
        eval_chunk=64,
        row_multiple=4,
    )
    defaults.update(kw)
    return TrainConfig(**defaults)


def test_training_learns_ranking(dataset, tmp_path):
    cfg = make_cfg(dataset, tmp_path, nr_pass=9, eval_every=3)
    tr = Trainer(cfg)
    tr.init_state()
    rows = []
    tr.run(log=rows.append)
    m = tr.validate()
    # Planted class structure: the model must beat random ranking.  Note
    # train positives are NOT masked from the ranking (reference semantics,
    # ffm.cpp prec_k) and each user has ~5 of them in a 40-item catalog, so
    # p@5 mostly measures train positives — use AUC/nDCG/p@10 instead.
    assert m["auc"] > 0.62
    assert m["ndcg@10"] > 0.15
    assert m["p@10"] > 0.04  # random baseline ~= avg_va_labels/40 ~= 0.025
    # reference-format output rows were produced
    assert any(r.strip().startswith("3 ") or r.startswith(" 3") for r in rows)


def test_text_model_roundtrip(dataset, tmp_path):
    model_path = str(tmp_path / "model.txt")
    cfg = make_cfg(dataset, tmp_path, nr_pass=2, model_path=model_path)
    tr = Trainer(cfg)
    tr.init_state()
    tr.run(log=lambda *_: None)
    assert os.path.exists(model_path)
    layout, k, params = load_text_model(model_path)
    assert k == cfg.k
    assert layout.fu == tr.data.layout.fu
    assert layout.fv == tr.data.layout.fv
    orig = tr.params_numpy()
    for f12, blk in orig.items():
        for name in ("W", "H"):
            np.testing.assert_allclose(
                params[f12][name], blk[name], rtol=2e-5, atol=1e-7
            )


def test_checkpoint_resume(dataset, tmp_path):
    ck = str(tmp_path / "ckpt")
    cfg = make_cfg(dataset, tmp_path, nr_pass=4, eval_every=2, ckpt_dir=ck)
    tr = Trainer(cfg)
    tr.init_state()
    tr.run(log=lambda *_: None)
    params4, epoch4 = load_checkpoint(ck)
    assert epoch4 == 4

    # fresh trainer resumes at epoch 4 and continues to 6
    cfg2 = make_cfg(
        dataset, tmp_path, nr_pass=6, eval_every=2, ckpt_dir=ck, resume=True
    )
    tr2 = Trainer(cfg2)
    tr2.init_state()
    assert tr2.epoch_idx == 4
    tr2.run(log=lambda *_: None)
    assert tr2.epoch_idx == 6

    # compare against an uninterrupted 6-epoch run with the same seed
    cfg3 = make_cfg(dataset, tmp_path, nr_pass=6, eval_every=6)
    tr3 = Trainer(cfg3)
    tr3.init_state()
    tr3.run(log=lambda *_: None)
    p_res = tr2.params_numpy()
    p_ful = tr3.params_numpy()
    for f12 in p_ful:
        np.testing.assert_allclose(
            p_res[f12]["W"], p_ful[f12]["W"], rtol=1e-7, atol=1e-9
        )


def test_predict_topk(dataset, tmp_path):
    cfg = make_cfg(dataset, tmp_path, nr_pass=3, eval_every=3)
    tr = Trainer(cfg)
    tr.init_state()
    tr.run(log=lambda *_: None)
    top = tr.predict_topk(k=10)
    assert top.shape == (tr.evaluator.meta.mt_true, 10)
    assert top.min() >= 0
    assert top.max() < tr.evaluator.meta.catalog
    # rows are distinct item ids
    assert all(len(set(row.tolist())) == 10 for row in top)


def test_cli_smoke(dataset, tmp_path, capsys):
    from one_class_ffm_tpu.cli import main

    item, train, va = dataset
    rc = main(
        [
            item,
            train,
            "-p",
            va,
            "-k",
            "3",
            "-t",
            "2",
            "--eval-every",
            "2",
            "--dtype",
            "float64",
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "iter" in out
    assert "ploss" in out


def test_orbax_checkpoint_resume(dataset, tmp_path):
    from one_class_ffm_tpu.utils import orbax_ckpt

    if not orbax_ckpt.available():
        pytest.skip("orbax not installed")
    ck = str(tmp_path / "ock")
    cfg = make_cfg(dataset, tmp_path, nr_pass=4, eval_every=2,
                   ckpt_dir=ck, ckpt_format="orbax")
    tr = Trainer(cfg)
    tr.init_state()
    tr.run(log=lambda *_: None)
    assert orbax_ckpt.has_checkpoint(ck)

    cfg2 = make_cfg(dataset, tmp_path, nr_pass=6, eval_every=2,
                    ckpt_dir=ck, ckpt_format="orbax", resume=True)
    tr2 = Trainer(cfg2)
    tr2.init_state()
    assert tr2.epoch_idx == 4
    tr2.run(log=lambda *_: None)

    cfg3 = make_cfg(dataset, tmp_path, nr_pass=6, eval_every=6)
    tr3 = Trainer(cfg3)
    tr3.init_state()
    tr3.run(log=lambda *_: None)
    p_res, p_ful = tr2.params_numpy(), tr3.params_numpy()
    for f12 in p_ful:
        np.testing.assert_allclose(
            p_res[f12]["W"], p_ful[f12]["W"], rtol=1e-7, atol=1e-9
        )


def test_cli_config_file(dataset, tmp_path, capsys):
    import json

    from one_class_ffm_tpu.cli import main

    item, train, va = dataset
    cfgf = tmp_path / "run.json"
    cfgf.write_text(json.dumps({"k": 5, "nr_pass": 2, "eval_every": 2,
                                "dtype": "float64", "test_path": va}))
    rc = main([item, train, "--config", str(cfgf)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "iter" in out

    # explicit CLI flag overrides the config file
    model = str(tmp_path / "m.txt")
    rc = main([item, train, "--config", str(cfgf), "-k", "2", "-o", model])
    assert rc == 0
    from one_class_ffm_tpu.train import load_text_model

    _, k, _ = load_text_model(model)
    assert k == 2

    # unknown keys rejected
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nope": 1}))
    assert main([item, train, "--config", str(bad)]) == 1


def test_trainer_mesh_matches_single_device(dataset, tmp_path):
    """The product surface runs sharded: a Trainer on the 8-device data mesh
    produces identical metrics and parameters to the single-device Trainer
    (GSPMD sharding is pure placement).  Reference analog: the thread knob
    wired into the binary, train.cpp:174."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tr1 = Trainer(make_cfg(dataset, tmp_path, nr_pass=4, eval_every=4))
    tr1.run(log=lambda *_: None)
    m1 = tr1.validate()

    tr8 = Trainer(make_cfg(dataset, tmp_path, nr_pass=4, eval_every=4,
                           mesh_shape="8"))
    assert tr8.mesh is not None and tr8.mesh.devices.size == 8
    tr8.run(log=lambda *_: None)
    # training state actually lives distributed across the mesh
    assert not tr8.state["a"].sharding.is_fully_replicated
    m8 = tr8.validate()
    for key, val in m1.items():
        np.testing.assert_allclose(m8[key], val, rtol=1e-9, err_msg=key)
    p1, p8 = tr1.params_numpy(), tr8.params_numpy()
    for f12 in p1:
        np.testing.assert_allclose(p8[f12]["W"], p1[f12]["W"],
                                   rtol=1e-9, atol=1e-11)


def test_trainer_sharded_blocked_active(dataset, tmp_path):
    """The shard-aligned blocked path (pad_labels shard_rows + shard_map
    passes) is reachable through the PRODUCT surface — a Trainer on the
    8-device mesh actually activates it (asserted, not assumed) and its
    metrics/parameters match the single-device blocked run."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    kw = dict(nr_pass=4, eval_every=4, blocked_bm=8)
    tr1 = Trainer(make_cfg(dataset, tmp_path, **kw))
    assert tr1.meta.blocked_bm_u == 8 and tr1.meta.blocked_shards == 1
    tr1.run(log=lambda *_: None)
    m1 = tr1.validate()

    tr8 = Trainer(make_cfg(dataset, tmp_path, mesh_shape="8", **kw))
    assert tr8.meta.blocked_shards == 8, "sharded blocked layout rejected"
    # round 4: the v layout is built under shards too and the slot-order
    # carry engages — both sides run shard_map-local blocked passes
    assert tr8.meta.blocked_bm_u == 8 and tr8.meta.blocked_bm_v == 8
    assert tr8.solver.pregather_u and tr8.solver.blk_yt
    assert tr8.solver.blk_v_on
    tr8.run(log=lambda *_: None)
    assert not tr8.state["a"].sharding.is_fully_replicated
    m8 = tr8.validate()
    for key, val in m1.items():
        np.testing.assert_allclose(m8[key], val, rtol=1e-6, err_msg=key)
    p1, p8 = tr1.params_numpy(), tr8.params_numpy()
    for f12 in p1:
        np.testing.assert_allclose(p8[f12]["W"], p1[f12]["W"],
                                   rtol=1e-6, atol=1e-9)


def test_trainer_2d_mesh_model_sharding(dataset, tmp_path):
    """NxM mesh through the Trainer: tables above model_min_rows row-shard on
    the model axis (d_multiple padding makes any dim divisible), and results
    match a model-axis-only run with the same padding."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    kw = dict(nr_pass=3, eval_every=3, model_min_rows=8)
    tr_ref = Trainer(make_cfg(dataset, tmp_path, mesh_shape="1x2", **kw))
    tr_ref.run(log=lambda *_: None)
    tr = Trainer(make_cfg(dataset, tmp_path, mesh_shape="4x2", **kw))
    tr.run(log=lambda *_: None)
    sharded = [
        t for blk in tr.state["params"].values() for t in blk.values()
        if not t.sharding.is_fully_replicated
    ]
    assert sharded, "no table sharded on the model axis"
    m_ref, m = tr_ref.validate(), tr.validate()
    for key, val in m_ref.items():
        np.testing.assert_allclose(m[key], val, rtol=1e-9, err_msg=key)
    p_ref, p = tr_ref.params_numpy(), tr.params_numpy()
    for f12 in p_ref:
        np.testing.assert_allclose(p[f12]["W"], p_ref[f12]["W"],
                                   rtol=1e-9, atol=1e-11)


def test_trainer_item_sharded_eval_matches(dataset, tmp_path):
    """--eval-shard items through the Trainer: metrics and predictions
    identical to the single-device dense path."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tr1 = Trainer(make_cfg(dataset, tmp_path, nr_pass=3, eval_every=3))
    tr1.run(log=lambda *_: None)
    m1 = tr1.validate()
    top1 = tr1.predict_topk(k=7)

    tr8 = Trainer(make_cfg(dataset, tmp_path, nr_pass=3, eval_every=3,
                           mesh_shape="8", eval_shard="items"))
    assert tr8.evaluator._item_mesh is not None
    tr8.run(log=lambda *_: None)
    m8 = tr8.validate()
    for key, val in m1.items():
        np.testing.assert_allclose(m8[key], val, rtol=1e-9, err_msg=key)
    top8 = tr8.predict_topk(k=7)
    np.testing.assert_array_equal(top8, top1)


def test_cli_mesh_flag(dataset, tmp_path, capsys):
    from one_class_ffm_tpu.cli import main

    item, train, va = dataset
    rc = main([item, train, "-p", va, "-k", "3", "-t", "2",
               "--eval-every", "2", "--dtype", "float64", "--mesh", "8"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "iter" in out and "ploss" in out


def test_verbose_describe(dataset, tmp_path):
    cfg = make_cfg(dataset, tmp_path, nr_pass=1)
    tr = Trainer(cfg)
    rows = []
    tr.describe(log=rows.append)
    text = "\n".join(rows)
    assert "users=120" in text and "blocks=" in text and "params=" in text


def test_bfloat16_training_is_finite(dataset, tmp_path):
    """bf16 storage: experimental, but must not diverge/NaN on tiny data."""
    cfg = make_cfg(dataset, tmp_path, nr_pass=3, eval_every=3, dtype="bfloat16")
    tr = Trainer(cfg)
    tr.init_state()
    tr.run(log=lambda *_: None)
    m = tr.validate()
    assert np.isfinite(m["ploss"])
    assert 0.0 <= m["auc"] <= 1.0
    for f12, blk in tr.params_numpy().items():
        assert np.all(np.isfinite(blk["W"].astype(np.float32)))


def test_profiler_trace_writes_output(dataset, tmp_path):
    prof = str(tmp_path / "trace")
    cfg = make_cfg(dataset, tmp_path, nr_pass=1, eval_every=1, profile_dir=prof)
    tr = Trainer(cfg)
    tr.init_state()
    tr.run(log=lambda *_: None)
    assert os.path.isdir(prof)
    found = [f for _, _, fs in os.walk(prof) for f in fs]
    assert found, "profiler trace produced no files"


def test_bfloat16_checkpoint_resume(dataset, tmp_path):
    """bf16 trainer must npz-round-trip: stored f32 (np.load cannot cast the
    ml_dtypes.bfloat16 descr), resumed back into bf16 tables."""
    ck = str(tmp_path / "ckbf")
    cfg = make_cfg(dataset, tmp_path, nr_pass=2, eval_every=2, ckpt_dir=ck,
                   dtype="bfloat16")
    tr = Trainer(cfg)
    tr.init_state()
    tr.run(log=lambda *_: None)
    params, epoch = load_checkpoint(ck)
    assert epoch == 2
    for blk in params.values():
        assert blk["W"].dtype == np.float32  # storage dtype, not |V2

    cfg2 = make_cfg(dataset, tmp_path, nr_pass=4, eval_every=2, ckpt_dir=ck,
                    dtype="bfloat16", resume=True)
    tr2 = Trainer(cfg2)
    tr2.init_state()
    assert tr2.epoch_idx == 2
    tr2.run(log=lambda *_: None)
    assert tr2.epoch_idx == 4
    for blk in tr2.params_numpy().values():
        assert np.isfinite(np.asarray(blk["W"], np.float32)).all()


def test_cg_precond_flag_and_none_path(dataset, tmp_path):
    """--cg-precond maps into TrainConfig; 'none' (reference-exact plain CG)
    trains fine end-to-end."""
    from one_class_ffm_tpu.cli import build_parser, config_from_args

    item, train, va = dataset
    args = build_parser().parse_args([item, train, "--cg-precond", "none"])
    assert config_from_args(args).cg_precond == "none"
    assert config_from_args(
        build_parser().parse_args([item, train])).cg_precond == "auto"

    cfg = make_cfg(dataset, tmp_path, nr_pass=2, eval_every=2,
                   cg_precond="none", dtype="float32")
    tr = Trainer(cfg)
    tr.init_state()
    m = tr.run(log=lambda *_: None)
    assert m and m["ploss"] == m["ploss"]


def test_blocked_positive_ops_match_plain(dataset, tmp_path):
    """Trainer with the blocked-sorted positive ops == plain COO ops (f64
    exact to solver tolerance); the blocked layout must actually engage."""
    cfg_b = make_cfg(dataset, tmp_path, nr_pass=3, eval_every=3, blocked_bm=8)
    cfg_p = make_cfg(dataset, tmp_path, nr_pass=3, eval_every=3, blocked_bm=0)
    tr_b, tr_p = Trainer(cfg_b), Trainer(cfg_p)
    assert tr_b.meta.blocked_bm_u == 8
    assert tr_p.meta.blocked_bm_u == 0
    tr_b.init_state()
    tr_p.init_state()
    mb = tr_b.run(log=lambda *_: None)
    mp = tr_p.run(log=lambda *_: None)
    assert abs(mb["ploss"] - mp["ploss"]) < 1e-8
    pb, pp = tr_b.params_numpy(), tr_p.params_numpy()
    for f12 in pp:
        np.testing.assert_allclose(pb[f12]["W"], pp[f12]["W"],
                                   rtol=1e-8, atol=1e-10)


def test_nan_guard_trips_on_poisoned_state(dataset, tmp_path):
    """Finiteness tripwire (VERDICT r4 #6): a NaN table row must abort the
    run at the NEXT eval with the offending block named — not train to
    completion logging `ploss: nan` (the round-4 f32 CG underflow mode;
    the reference would log nan silently too, ffm.cpp:1002)."""
    import jax.numpy as jnp

    from one_class_ffm_tpu.train import NonFiniteMetricError

    cfg = make_cfg(dataset, tmp_path, nr_pass=4, eval_every=2)
    tr = Trainer(cfg)
    tr.init_state()
    f12 = next(iter(tr.state["params"]))
    W = tr.state["params"][f12]["W"]
    tr.state["params"][f12]["W"] = jnp.full_like(W, jnp.nan)
    rows = []
    with pytest.raises(NonFiniteMetricError) as ei:
        tr.run(log=rows.append)
    msg = str(ei.value)
    assert "epoch 2" in msg  # first eval, not the end of the run
    assert f"[f12={f12}]" in msg  # the poisoned block is named
    # no metric row was logged as if healthy (only the header)
    assert not any(r.strip() and r.strip()[0].isdigit() for r in rows)

    # guard disabled (--no-nan-guard): reference behavior — the run
    # completes, logging nan rows for forensics
    cfg2 = make_cfg(dataset, tmp_path, nr_pass=2, eval_every=2,
                    nan_guard=False)
    tr2 = Trainer(cfg2)
    tr2.init_state()
    W2 = tr2.state["params"][f12]["W"]
    tr2.state["params"][f12]["W"] = jnp.full_like(W2, jnp.nan)
    rows2 = []
    tr2.run(log=rows2.append)
    assert any("nan" in r for r in rows2)


def test_refresh_every_bounds_carry_drift(dataset, tmp_path):
    """Round-5 incident (PARITY.md): at bf16 storage the incrementally
    carried caches (yt/P/Q/a/b) drift from the table-derived truth and the
    drift COMPOUNDS into divergence at sweep scale.  refresh_every
    re-derives them; right after a refresh the carried residual must equal
    the freshly derived one exactly, and with refresh off a few bf16
    epochs must show measurable drift (the disease being treated)."""
    import numpy as np

    def drift(tr):
        sol = tr.solver
        carried = np.asarray(sol.yt_stream(tr.state), np.float32)
        fresh = sol.refresh_caches({"params": tr.state["params"]})
        return np.abs(carried
                      - np.asarray(sol.yt_stream(fresh), np.float32)).max()

    cfg0 = make_cfg(dataset, tmp_path, nr_pass=4, dtype="bfloat16",
                    refresh_every=0)
    tr0 = Trainer(cfg0)
    tr0.init_state()
    tr0.run(log=lambda *_: None)
    assert drift(tr0) > 0  # unrefreshed bf16 bookkeeping drifts

    cfg1 = make_cfg(dataset, tmp_path, nr_pass=4, dtype="bfloat16",
                    refresh_every=2)
    tr1 = Trainer(cfg1)
    tr1.init_state()
    tr1.run(log=lambda *_: None)
    assert drift(tr1) == 0  # epoch 4 ended on a refresh — drift reset

    # auto cadence: ON at bf16, OFF at f64 (f32/f64 hold parity without it)
    assert tr1.refresh_every == 2
    assert Trainer(make_cfg(dataset, tmp_path, nr_pass=0,
                            dtype="bfloat16")).refresh_every == 10
    assert Trainer(make_cfg(dataset, tmp_path, nr_pass=0)).refresh_every == 0


def test_refresh_every_f64_is_identity(dataset, tmp_path):
    """At f64 a cache re-derivation is numerically the identity — training
    with refresh_every must reproduce the unrefreshed run to fp noise."""
    import numpy as np

    runs = {}
    for every in (0, 2):
        cfg = make_cfg(dataset, tmp_path, nr_pass=6, refresh_every=every)
        tr = Trainer(cfg)
        tr.init_state()
        tr.run(log=lambda *_: None)
        runs[every] = tr.params_numpy()
    for f12, blk in runs[0].items():
        for key in ("W", "H"):
            np.testing.assert_allclose(
                runs[2][f12][key], blk[key], rtol=1e-8, atol=1e-10)


def test_divergence_guard_trips_on_exploded_ploss(dataset, tmp_path):
    """The tripwire also catches FINITE explosions (round-5 bf16 spiral:
    ploss 77 at its first bad eval — the nan check alone missed it)."""
    from one_class_ffm_tpu.train import NonFiniteMetricError

    cfg = make_cfg(dataset, tmp_path, nr_pass=0)
    tr = Trainer(cfg)
    tr.init_state()
    tr.epoch_idx = 7
    with pytest.raises(NonFiniteMetricError) as ei:
        tr._check_finite({"ploss": 77.2, "p@5": 0.01})
    assert "diverged" in str(ei.value) and "epoch 7" in str(ei.value)
    tr._check_finite({"ploss": 5.4, "p@5": 1.0})  # corpus-max is fine
    cfg2 = make_cfg(dataset, tmp_path, nr_pass=0, max_ploss=0.0)
    tr2 = Trainer(cfg2)
    tr2.init_state()
    tr2._check_finite({"ploss": 77.2})  # guard disabled
