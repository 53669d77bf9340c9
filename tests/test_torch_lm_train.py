"""PyTorch port, the LM trainer: ``repro_torch.launch.train`` against
``repro.launch.train`` on reduced configs.

Compared:
- one ``make_train_step`` step from the same weights on the same batch:
  reduced yi-6b (AdamW) and qwen3-moe (Adafactor, its config's optimizer);
  the loss, every updated parameter and every optimizer-state leaf;
- ``train_loop`` in both packages from one step-0 checkpoint that the
  reference's ``Checkpointer`` wrote from its own init: the losses step by
  step, for yi-6b (AdamW, ``compress_grads``) and qwen3-moe (Adafactor);
- a resume across packages: the reference trains 4 steps and saves, the
  port resumes to 8, and its losses are the reference's uninterrupted run's;
- the port's own loop: an injected failure retried from the last
  checkpoint, and an auto-resume that continues where the run stopped.

Tolerances:
- the loss: ``LOSS`` (rtol 1e-5). The step's gradients agree to 1e-5 of
  each leaf's max |grad| (``tests/test_torch_lm_grads.py``) and a few steps
  at these learning rates move the loss by less (measured: 1.6e-7).
- after one step, the parameters move by ``lr x update``. Adafactor's update
  is smooth in the gradient, so each leaf's move is held within
  ``GRAD_REL`` (1e-5) of that leaf's largest move, plus one ULP of the new
  parameter (each package rounds it to f32 on its own). AdamW's first update is
  ``g / (|g| + eps)``, about the sign of each gradient; where |g| is within
  the gradients' cross-package tolerance of 0 (``SIGN_UNDECIDED``, 1e-3 of
  the leaf's max |grad|) that sign is not determined, so only the other
  entries are held to ``GRAD_REL`` of the leaf's largest move; the rest
  must move by at most ``lr x (1 + weight decay x |p|)``.
- optimizer state: within ``2 x GRAD_REL`` of each leaf's max (AdamW's
  ``v`` and Adafactor's factored moments hold squares of the gradient).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config, reduced_config
from repro.data.lm_data import batch_at_step
from repro.launch import train as JT
from repro.models import lm as J
from repro.optim import optimizers as JO
from repro_torch import configs as TC
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.ckpt import _leaves_with_path
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import train as TT
from repro_torch.optim import optimizers as TO

LOSS = dict(rtol=1e-5, atol=0)
GRAD_REL, SIGN_UNDECIDED = 1e-5, 1e-3
WEIGHT_DECAY = 0.01  # adamw()'s default
LOOP = dict(batch=4, seq=16, save_every=100)
ARCHS = {"yi-6b": True, "qwen3-moe-235b-a22b": False}  # arch -> compress_grads


def configs(arch):
    return reduced_config(get_config(arch)), TC.reduced_config(TC.get_config(arch))


def flat(tree) -> dict:
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v, np.float32)
            for k, v in _leaves_with_path(tree)}


def step0_checkpoint(cfg, directory, compress):
    """The reference's init and optimizer state, saved as step 0."""
    jp = J.init_params(cfg, jax.random.PRNGKey(0))
    opt = JT.init_opt_state(JO.get_optimizer(cfg.optimizer), jp, compress_grads=compress)
    JCheckpointer(directory, async_write=False).save(0, {"params": jp, "opt": opt})


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_matches_reference(arch):
    cfg, tcfg = configs(arch)
    lr = 1e-2
    kw = dict(peak_lr=lr, warmup=0, total_steps=10)
    jopt, topt = JO.get_optimizer(cfg.optimizer), TO.get_optimizer(tcfg.optimizer)
    jp = J.init_params(cfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.device_get(jp), device="cpu")
    p0 = flat(jax.device_get(jp))
    nb = batch_at_step(cfg, seed=0, step=0, host=0, n_hosts=1, batch=4, seq=16)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}

    (_, jg) = jax.value_and_grad(lambda p: J.loss_fn(cfg, p, jb)[0])(jp)
    g_ref = flat(jax.device_get(jg))
    jnew, jstate, jm = jax.jit(JT.make_train_step(cfg, jopt, **kw))(
        jp, JT.init_opt_state(jopt, jp), jb)
    tnew, tstate, tm = TT.make_train_step(tcfg, topt, **kw)(
        tp, TT.init_opt_state(topt, tp), {k: torch.from_numpy(v) for k, v in nb.items()})

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert float(tm["lr"]) > 0
    want, got = flat(jax.device_get(jnew)), flat(tnew)
    assert sorted(got) == sorted(want)
    for k in want:
        move_w, move_g = want[k] - p0[k], got[k] - p0[k]
        scale = float(np.abs(move_w).max())
        held = np.ones(move_w.shape, bool)
        if cfg.optimizer == "adamw":
            held = np.abs(g_ref[k]) > SIGN_UNDECIDED * float(np.abs(g_ref[k]).max())
            # |m / (sqrt(v) + eps)| <= 1, plus the weight decay, plus f32
            # rounding of the new parameter
            bound = lr * (1 + WEIGHT_DECAY * np.abs(p0[k])) + 1e-6
            assert np.all(np.abs(move_g[~held]) <= bound[~held]), k
        # each new parameter is rounded to f32 on its own: one ULP of it more
        tol = GRAD_REL * scale + np.spacing(np.abs(want[k]))
        bad = held & (np.abs(move_g - move_w) > tol)
        assert not bad.any(), f"{k}: {int(bad.sum())} moves off by more than {GRAD_REL:g} x {scale:.3e}"
    js, ts = flat(jax.device_get(jstate)), flat(tstate)
    assert sorted(js) == sorted(ts)
    for k in js:
        if k.endswith("step"):
            assert tstate["inner"]["step"].dtype == torch.int32 and ts[k] == js[k] == 1
            continue
        err = float(np.abs(ts[k] - js[k]).max())
        assert err <= 2 * GRAD_REL * float(np.abs(js[k]).max()), (k, err)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_loop_from_reference_checkpoint(arch, tmp_path):
    cfg, tcfg = configs(arch)
    compress = ARCHS[arch]
    dj, dt = str(tmp_path / "ref"), str(tmp_path / "port")
    step0_checkpoint(cfg, dj, compress)
    shutil.copytree(dj, dt)
    want = JT.train_loop(cfg, steps=6, ckpt_dir=dj, compress_grads=compress, **LOOP)
    got = TT.train_loop(tcfg, steps=6, ckpt_dir=dt, compress_grads=compress, device="cpu",
                        **LOOP)
    assert got["steps_run"] == want["steps_run"] == 6
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS)
    assert got["final_params"]["embed"].device.type == "cpu"


def test_port_resumes_reference_run(tmp_path):
    cfg, tcfg = configs("yi-6b")
    d_full, d_cut = str(tmp_path / "full"), str(tmp_path / "cut")
    full = JT.train_loop(cfg, steps=8, batch=4, seq=16, ckpt_dir=d_full, save_every=4)
    first = JT.train_loop(cfg, steps=4, batch=4, seq=16, ckpt_dir=d_cut, save_every=4)
    np.testing.assert_allclose(first["losses"], full["losses"][:4], rtol=1e-6)
    assert JCheckpointer(d_cut).latest_step() == 4
    rest = TT.train_loop(tcfg, steps=8, batch=4, seq=16, ckpt_dir=d_cut, save_every=4,
                         device="cpu")
    assert rest["steps_run"] == 4
    np.testing.assert_allclose(rest["losses"], full["losses"][4:], **LOSS)
    assert Checkpointer(d_cut).latest_step() == 8


def test_loop_retries_injected_failure_and_resumes(tmp_path):
    """An injected failure at step 6 restores the step-4 checkpoint and runs
    step 6 again; a second run on the directory resumes at step 12."""
    _, tcfg = configs("yi-6b")
    d = str(tmp_path / "ck")
    kw = dict(batch=4, seq=16, ckpt_dir=d, save_every=4, compress_grads=True, device="cpu")
    first = TT.train_loop(tcfg, steps=12, inject_failure_at=6, **kw)
    assert first["steps_run"] == 12 and first["watchdog"]["steps"] == 12
    assert np.all(np.isfinite(first["losses"]))
    assert Checkpointer(d).list_steps() == [4, 8, 12]
    second = TT.train_loop(tcfg, steps=16, **kw)
    assert second["steps_run"] == 4
    step, state = Checkpointer(d).restore(
        {"opt": {"inner": {"step": torch.zeros((), dtype=torch.int32)}}}, device="cpu")
    # the retry rolled the state back to step 4 and went on with step 6, as
    # the reference's loop does: the optimizer has taken 2 steps fewer
    assert step == 16 and int(state["opt"]["inner"]["step"]) == 14
    # up to the failure, the run is the run without one, to the bit
    clean = TT.train_loop(tcfg, steps=12, batch=4, seq=16, compress_grads=True, device="cpu")
    np.testing.assert_array_equal(first["losses"][:6], clean["losses"][:6])
    assert first["losses"][6] != clean["losses"][6]


def test_loop_retry_waits_for_a_checkpoint_in_flight(tmp_path, monkeypatch):
    """The retry restores the newest checkpoint saved before the failure even
    while its asynchronous write is still running (each write held back 0.3
    s here; on the card two reduced steps take less than a write): after 12
    steps with a failure at step 6 the optimizer has taken 10, the 2 steps
    rolled back to the step-4 checkpoint taken again."""
    import time

    from repro_torch.checkpoint import ckpt as ckpt_mod

    write = ckpt_mod.Checkpointer._write

    def slow_write(self, *args):
        time.sleep(0.3)
        return write(self, *args)

    monkeypatch.setattr(ckpt_mod.Checkpointer, "_write", slow_write)
    _, tcfg = configs("yi-6b")
    d = str(tmp_path / "ck")
    first = TT.train_loop(tcfg, steps=12, inject_failure_at=6, batch=4, seq=16, ckpt_dir=d,
                          save_every=4, device="cpu")
    assert first["steps_run"] == 12
    step, state = Checkpointer(d).restore(
        {"opt": {"inner": {"step": torch.zeros((), dtype=torch.int32)}}}, device="cpu")
    assert step == 12 and int(state["opt"]["inner"]["step"]) == 10


def test_optimizer_state_crosses_through_convert():
    """``convert.lm_params_from_numpy`` carries an optimizer state: int32
    ``step`` and Adafactor's factored ``vr`` / ``vc``."""
    cfg, _ = configs("qwen3-moe-235b-a22b")
    jp = J.init_params(cfg, jax.random.PRNGKey(0))
    jstate = jax.device_get(JT.init_opt_state(JO.adafactor(), jp, compress_grads=True))
    tstate = lm_params_from_numpy(jstate, device="cpu")
    assert tstate["inner"]["step"].dtype == torch.int32 and tstate["inner"]["step"].shape == ()
    want = dict(_leaves_with_path(jstate))
    got = dict(_leaves_with_path(tstate))
    assert sorted(got) == sorted(want)
    assert any(k.endswith("/vr") for k in got) and any(k.endswith("/vc") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    ours = dict(_leaves_with_path(TT.init_opt_state(
        TO.adafactor(), lm_params_from_numpy(jax.device_get(jp), device="cpu"),
        compress_grads=True)))
    assert sorted(ours) == sorted(want)
    for k in want:
        assert tuple(ours[k].shape) == want[k].shape, k


def test_main_runs_reduced_on_cpu(tmp_path, monkeypatch, capsys):
    d = str(tmp_path / "ck")
    monkeypatch.setattr("sys.argv", ["train", "--arch", "yi-6b", "--reduced", "--steps", "3",
                                     "--batch", "2", "--seq", "8", "--ckpt-dir", d,
                                     "--save-every", "3", "--device", "cpu"])
    TT.main()
    assert "ran 3 steps" in capsys.readouterr().out
    assert os.path.isdir(os.path.join(d, "step_00000003"))


def test_roofline_terms_on_the_cards_constants():
    """``launch.hw.roofline_terms`` has the reference's signature and keys,
    on the H100's rates."""
    from repro.launch import hw as JH
    from repro_torch.launch import hw

    kw = dict(flops=2 * hw.PEAK_FLOPS_F32, bytes_hbm=hw.HBM_BW, bytes_collective=0.0, chips=2)
    got, want = hw.roofline_terms(**kw), JH.roofline_terms(**kw)
    assert sorted(got) == sorted(want)
    assert got["compute_s"] == got["memory_s"] * 2 == 1.0
    assert got["dominant"] == "compute" and got["bound_s"] == 1.0
    terms = hw.roofline_terms(flops=0.0, bytes_hbm=0.0, bytes_collective=hw.NVLINK_BW, chips=1)
    assert terms["dominant"] == "collective" and terms["bound_s"] == 1.0
