"""Kinds of configuration: a kind found by its name, and the LM decode kind
at a reduced minicpm3-4b on the CPU (the port's ``reduced_config``
widths): a run that passes, the control and each planted fault failing,
the plain reference against the port's full forward pass, and the work
count by hand."""

import copy
import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from xmrbench import harness, lm_reference
from xmrbench.kinds import lm_decode

from conftest import ROOT

SEED = 2**31 + 17


def _tiny_lm(check=6e-3):
    """The minicpm3-4b configuration at the port's reduced widths, under a
    mix of 2 prompts of 24 ids asked twice each, answers of 8."""
    from repro_torch.configs.base import get_config, reduced_config

    r = reduced_config(get_config("minicpm3-4b"))
    cfg = json.loads((ROOT / "xmrbench/configs/minicpm3-4b.json").read_text())
    cfg["model"].update({k: getattr(r, k) for k in (
        "n_layers", "d_model", "n_heads", "d_ff", "vocab", "q_lora_rank", "kv_lora_rank",
        "qk_rope_dim", "qk_nope_dim", "v_head_dim")})
    cfg["check"] = {"logit_gap": check}
    mix = json.loads((ROOT / "xmrbench/traffic/decode-16x8k.json").read_text())
    mix.update(prompts=2, asks=2, prompt_len=24, answer_len=8, trace_calls=2,
               breakdown_calls=1, judge_sequences=2, judge_steps=4)
    ref = harness.load_cell("minicpm3-decode-8k")
    return harness.Cell("tiny-lm", 1, cfg, mix, ref.end_to_end, ref.per_layer)


def _run(cell, traced=False, hook=None, seconds=1.5):
    """A run long enough for a whole tiny answer (8 steps) on a loaded CPU."""
    return harness.run_cell(cell, SEED, seconds, traced, device="cpu",
                            t_start=time.perf_counter(), engine_hook=hook)


def test_lm_cell_loads_by_name():
    cell = harness.load_cell("minicpm3-decode-8k")
    assert cell.config["kind"] == "lm_decode" and cell.mix["mode"] == "decode"
    assert {m["name"] for m in cell.end_to_end} == {
        "decode_tok_s", "decode_step_p95_ms", "peak_mem_gb", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "decode_mfu", "idle_share.decode", "activities_per_step.decode"}


def test_config_file_is_the_registered_model():
    """The file states minicpm3-4b as the port registers it: nothing cut."""
    from repro_torch.configs.base import get_config

    cfg = json.loads((ROOT / "xmrbench/configs/minicpm3-4b.json").read_text())
    assert lm_decode.arch_config(cfg) == get_config("minicpm3-4b")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = [c for c in bench["configs"] if c["name"] == "minicpm3-4b"][0]
    assert entry["reduced"] == [] and entry["file"] == "xmrbench/configs/minicpm3-4b.json"
    bad = copy.deepcopy(cfg)
    bad["model"]["cache_dtype"] = "float32"
    with pytest.raises(ValueError):
        lm_decode.arch_config(bad)


def test_a_kind_loads_by_name_from_its_file(tmp_path):
    """A kind is a file: one written to another root runs through the
    harness's loop with no edit."""
    (tmp_path / "toy.py").write_text('''
from xmrbench.work import Work

def validate(config, mix):
    if mix["mode"] != "toy":
        raise ValueError(mix["mode"])

class Run:
    mode, per_call, warm_calls, trace_calls, breakdown_calls = "toy", 3, 1, 0, 0

    def __init__(self):
        self.kept = []

    def next_input(self, i):
        return i

    def call(self, x):
        return 2 * x

    def begin_window(self, i):
        self.first = i

    def keep(self, i, x, out):
        self.kept.append(out == 2 * i)

    def work(self, i0, i1):
        return Work(i1 - i0, 0.0, 0.0)

    def release(self):
        pass

    def check(self):
        return {"wrong": (self.kept.count(False), 0)}, self.kept.count(False)

def setup(config, mix, seed, seconds, traced, *, device, hook=None, marks=None):
    return Run()
''')
    assert harness.load_kind("toy", tmp_path).Run.mode == "toy"
    with pytest.raises(KeyError):
        harness.load_kind("absent", tmp_path)
    cell = harness.Cell("toy", 1, {"kind": "toy"}, {"mode": "toy"}, [], [], tmp_path)
    result, checks = _run(cell, seconds=0.05)
    assert result["correct"] is True and checks == {"wrong": (0, 0)}
    assert result["attempted"] % 3 == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


def test_lm_run_is_correct_and_well_formed():
    result, checks = _run(_tiny_lm())
    assert result["correct"] is True and result["failed"] == 0, checks
    assert result["attempted"] > 0 and result["attempted"] % 4 == 0
    assert set(result["checks"]) == {"logit_gap", "malformed", "weights_changed"}
    assert 0 < checks["logit_gap"][0] < 6e-3
    assert set(result["metrics"]) == {"setup_s"}          # nothing of the device off the chip
    assert list(result)[-1] == "checks"
    json.loads(json.dumps(result))


def test_lm_traced_run():
    result, _ = _run(_tiny_lm(), traced=True)
    assert result["correct"] is True
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


def test_lm_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails logit_gap."""
    result, checks = _run(_tiny_lm(), hook=lm_decode.control_hook())
    assert result["correct"] is False
    assert checks["logit_gap"][0] > checks["logit_gap"][1]


@pytest.mark.parametrize("fault", sorted(lm_decode.FAULTS))
def test_lm_faults_are_not_correct(fault):
    result, checks = _run(_tiny_lm(), hook=lm_decode.FAULTS[fault])
    assert result["correct"] is False, checks
    assert result["failed"] > 0
    if fault == "changed_weight":
        assert checks["weights_changed"][0] == 1


def test_lm_judged_steps_are_held_and_drawn_from_the_seed():
    cell = _tiny_lm()
    run = lm_decode.setup(cell.config, cell.mix, SEED, 0.3, False, device="cpu")
    again = lm_decode.setup(cell.config, cell.mix, SEED, 0.3, False, device="cpu")
    assert run.judge_steps == again.judge_steps and run.judge_seqs == again.judge_seqs
    half = run.batch // 2
    assert sum(b < half for b in run.judge_seqs) == sum(b >= half for b in run.judge_seqs) == 1
    assert len({b % run.n_prompts for b in run.judge_seqs}) == 2
    assert torch.equal(run.answers, again.answers) and torch.equal(run.prompts, again.prompts)
    run.begin_window(2)
    for i in range(2, 2 + 2 * run.answer_len):
        x = run.next_input(i)
        run.keep(i, x, run.call(x))
    assert sorted(run.kept) == sorted((r, j) for r in range(2) for j in run.judge_steps)


def test_lm_cell_draws_its_judged_sequences_in_both_halves():
    """The cell's own mix: 6 sequences, 3 in each half of the 16, of more than
    one prompt, at the first 32 steps of an answer."""
    cell = harness.load_cell("minicpm3-decode-8k")
    mix = dict(cell.mix, prompt_len=4)
    tiny = _tiny_lm()
    run = lm_decode.setup(tiny.config, mix, SEED, 0.3, False, device="cpu")
    assert run.batch == 16 and len(run.judge_seqs) == len(set(run.judge_seqs)) == 6
    assert sum(b < 8 for b in run.judge_seqs) == 3
    assert len({b % 4 for b in run.judge_seqs}) >= 2
    assert run.judge_steps == list(range(32))


def test_reference_matches_the_ports_forward():
    """lm_reference.forward against the port's lm.forward_train on the same
    weights, at the reduced widths, in float32: within 1e-5 of the largest
    logit (both float32, summed in different orders)."""
    from repro_torch.models import lm

    cell = _tiny_lm()
    cfg = lm_decode.arch_config(cell.config)
    w = lm_decode.make_weights(cfg, 5, "cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 40), generator=torch.Generator().manual_seed(3))
    want, _ = lm.forward_train(cfg, w, {"tokens": tokens})
    got = lm_reference.forward(w, lm_decode._model(cfg), tokens[0], range(40), qblock=16)
    assert got.shape == want[0].shape
    assert (got - want[0]).abs().max() <= 1e-5 * want.abs().max()


def test_reference_imports_nothing_of_the_program_and_turns_tf32_off():
    code = ("import sys; sys.path[:0] = [%r, %r]; import torch; "
            "torch.backends.cuda.matmul.allow_tf32 = True; torch.backends.cudnn.allow_tf32 = True; "
            "import xmrbench.lm_reference as r; "
            "w = {'embed': torch.ones(5, 4), 'final_norm': torch.ones(4), 'lm_head': torch.ones(4, 5), "
            "'layers': {'ln1': torch.ones(0, 4), 'ln2': torch.ones(0, 4), 'attn': {}, 'ffn': {}}}; "
            "m = dict(n_layers=0, n_heads=1, qk_nope_dim=2, qk_rope_dim=2, v_head_dim=2, "
            "rope_theta=1e4); r.forward(w, m, torch.tensor([1, 2]), [1]); "
            "print(sorted(n for n in sys.modules if n.split('.')[0] == 'repro_torch'), "
            "torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)"
            % (str(ROOT / "src"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False False"


def test_decode_work_by_hand():
    """One layer of every width 1 but vocab 3, 2 heads, a batch of 2."""
    m = dict(n_layers=1, d_model=1, n_heads=2, q_lora_rank=1, kv_lora_rank=1, qk_rope_dim=1,
             qk_nope_dim=1, v_head_dim=1, d_ff=1, vocab=3, rope_theta=1e4)
    w = lm_decode.decode_work(m, batch=2, attended=5)
    # matrices: wdq 1 + wuq 4 + wdkv 1 + wkr 1 + wukv 4 + wo 2 + ffn 3 = 16, head 3
    assert w.flops == 2 * 2 * 19 + 2 * (2 * 2 * 5 * (2 + 1))
    # weights and norms (2 + 1 + 1, final 1) in f32, two embedding rows, the
    # latent (2 values) read at 5 positions and written at 1 a sequence, logits
    assert w.nbytes == 4 * (19 + 5) + 4 * 2 + 2 * 2 * 2 * 6 + 4 * 2 * 3
    assert dataclasses.astuple(w)[2] == 0
