"""The LM MoE decode kind (``kinds/lm_moe_decode.py``) at a reduced
DeepSeek-V2-Lite on the CPU (the port's ``reduced_config`` widths): the
cell by name, the configuration file as the registered and the published
model, a run that passes, the control and each planted fault failing, the
tie rule, the plain reference against the port's full forward pass, and the
work count by hand and against brute force."""

import copy
import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from xmrbench import harness, lm_moe_reference
from xmrbench.kinds import lm_moe_decode

from conftest import ROOT

SEED = 2**31 + 29
CONFIG = ROOT / "xmrbench/configs/deepseek-v2-lite.json"
WIDTHS = ("n_layers", "d_model", "n_heads", "d_ff", "vocab", "kv_lora_rank", "qk_rope_dim",
          "qk_nope_dim", "v_head_dim", "n_experts", "experts_per_token", "moe_d_ff")


def _tiny(check=1e-4, tie=1e-4):
    """deepseek-v2-lite at the port's reduced widths (the published keys,
    which state the whole model, left out), under a mix of 2 prompts of 24
    ids asked twice each, answers of 8."""
    from repro_torch.configs.base import get_config, reduced_config

    r = reduced_config(get_config("deepseek-v2-lite"))
    cfg = json.loads(CONFIG.read_text())
    for key in list(lm_moe_decode.PUBLISHED) + ["q_lora_rank", "rope_scaling"]:
        del cfg[key]
    cfg["model"].update({k: getattr(r, k) for k in WIDTHS})
    cfg["model"]["yarn"]["original_max_position"] = r.yarn.original_max_position
    cfg["check"] = {"logit_gap": check, "tie_margin": tie}
    mix = json.loads((ROOT / "xmrbench/traffic/decode-16x8k.json").read_text())
    mix.update(prompts=2, asks=2, prompt_len=24, answer_len=8, trace_calls=2,
               breakdown_calls=1, judge_sequences=2, judge_steps=4)
    ref = harness.load_cell("dsv2lite-decode-8k")
    return harness.Cell("tiny-moe", 1, cfg, mix, ref.end_to_end, ref.per_layer)


def _run(cell, traced=False, hook=None, seconds=1.5):
    return harness.run_cell(cell, SEED, seconds, traced, device="cpu",
                            t_start=time.perf_counter(), engine_hook=hook)


def test_moe_cell_loads_by_name():
    cell = harness.load_cell("dsv2lite-decode-8k")
    assert cell.config["kind"] == "lm_moe_decode" and cell.mix["mode"] == "decode"
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {
        "decode_tok_s", "decode_step_p95_ms", "peak_mem_gb", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "decode_mfu", "idle_share.decode", "activities_per_step.decode", "moe_ms.decode",
        "moe_roofline.decode", "mla_ms.decode"}
    lm_moe_decode.validate(cell.config, cell.mix)


def test_config_file_is_the_registered_and_the_published_model():
    """The file states deepseek-v2-lite as the port registers it, nothing
    cut, and its published keys agree with the model as run."""
    from repro_torch.configs.base import get_config

    cfg = json.loads(CONFIG.read_text())
    assert lm_moe_decode.arch_config(cfg) == get_config("deepseek-v2-lite")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = [c for c in bench["configs"] if c["name"] == "deepseek-v2-lite"][0]
    assert entry["reduced"] == [] and entry["file"] == "xmrbench/configs/deepseek-v2-lite.json"
    assert entry["source"] == cfg["source"]
    mix = harness.load_cell("dsv2lite-decode-8k").mix
    for key, value in (("hidden_size", 4096), ("num_experts_per_tok", 8), ("q_lora_rank", 1536)):
        with pytest.raises(ValueError, match="not the published one"):
            lm_moe_decode.validate(dict(cfg, **{key: value}), mix)
    bad = copy.deepcopy(cfg)
    bad["rope_scaling"]["factor"] = 4
    with pytest.raises(ValueError, match="rope_scaling.factor"):
        lm_moe_decode.validate(bad, mix)
    bad = copy.deepcopy(cfg)
    bad["model"]["cache_dtype"] = "bfloat16"
    with pytest.raises(ValueError):
        lm_moe_decode.validate(bad, mix)
    dense = json.loads((ROOT / "xmrbench/configs/minicpm3-4b.json").read_text())
    with pytest.raises(ValueError, match="DeepSeek-V2"):
        lm_moe_decode.validate(dense, mix)


def test_moe_run_is_correct_and_well_formed():
    result, checks = _run(_tiny())
    assert result["correct"] is True and result["failed"] == 0, checks
    assert result["attempted"] > 0 and result["attempted"] % 4 == 0
    assert set(result["checks"]) == {"logit_gap", "swapped", "malformed", "weights_changed"}
    assert 0 < checks["logit_gap"][0] < 1e-5
    assert set(result["metrics"]) == {"setup_s"}          # nothing of the device off the chip
    assert list(result)[-1] == "checks"
    json.loads(json.dumps(result))


def test_moe_traced_run():
    result, _ = _run(_tiny(), traced=True)
    assert result["correct"] is True
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_moe_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails logit_gap."""
    result, checks = _run(_tiny(), hook=lm_moe_decode.control_hook())
    assert result["correct"] is False
    assert checks["logit_gap"][0] > 10 * checks["logit_gap"][1]


@pytest.mark.parametrize("fault", sorted(lm_moe_decode.FAULTS))
def test_moe_faults_are_not_correct(fault):
    result, checks = _run(_tiny(), hook=lm_moe_decode.FAULTS[fault])
    assert result["correct"] is False, checks
    assert result["failed"] > 0
    if fault == "changed_weight":
        assert checks["weights_changed"][0] == 1


def _flip_one_token(run, picked):
    """Make the program's held logits of one judged token those of the
    reference routed to the other expert at that token's nearest tie."""
    check = run.check

    def planted():
        b, j = run.judge_seqs[0], run.judge_steps[0]
        row = run.prompt_len + j
        for (r, step), out in run.kept.items():
            if step == j:
                seq = run._sequence(b, r, j)
                _, margin = lm_moe_reference.forward(run.w, run.model, seq, [row],
                                                     with_margins=True)
                layer = int(margin[0].argmin())
                out[b] = lm_moe_reference.forward(run.w, run.model, seq, [row],
                                                  swap=[(row, layer)])[0]
                picked.append(float(margin[0, layer]))
        return check()
    run.check = planted
    return run


@pytest.mark.parametrize("tie, correct", [(1e3, True), (0.0, False)])
def test_a_flip_at_a_near_tie_is_judged_against_the_swapped_routing(tie, correct):
    """A program that routes one judged token to its (K+1)-th expert at its
    nearest tie passes where that margin is under ``tie_margin``: the
    reference runs again with that swap, and the token is judged against
    it (``swapped`` 1). Under a tie margin of 0 the same token fails."""
    picked = []
    result, checks = _run(_tiny(tie=tie), hook=lambda run: _flip_one_token(run, picked))
    assert picked and result["correct"] is correct, checks
    assert checks["swapped"][0] == (1 if correct else 0)
    if not correct:
        assert checks["logit_gap"][0] > 10 * checks["logit_gap"][1]


def test_swapping_an_expert_moves_the_reference():
    """``swap`` routes the named row to its (K+1)-th expert at that layer:
    that row's logits move; the rows before it do not."""
    cfg = lm_moe_decode.arch_config(_tiny().config)
    w = lm_moe_decode.make_weights(cfg, 5, "cpu")
    model = lm_moe_decode._model(cfg)
    tokens = torch.randint(0, cfg.vocab, (20,), generator=torch.Generator().manual_seed(4))
    base, margins = lm_moe_reference.forward(w, model, tokens, range(20), qblock=8,
                                             with_margins=True)
    assert margins.shape == (20, cfg.n_layers - cfg.first_k_dense)
    alt = lm_moe_reference.forward(w, model, tokens, range(20), qblock=8, swap=[(12, 1)])
    assert torch.equal(alt[:12], base[:12])
    assert (alt[12] - base[12]).abs().max() > 1e-3


def test_reference_matches_the_ports_forward():
    """lm_moe_reference.forward against the port's lm.forward_train on the
    same weights, at the reduced widths, in float32: within 1e-5 of the
    largest logit (both float32, summed in different orders)."""
    from repro_torch.models import lm

    cfg = lm_moe_decode.arch_config(_tiny().config)
    w = lm_moe_decode.make_weights(cfg, 5, "cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 40), generator=torch.Generator().manual_seed(3))
    want, _ = lm.forward_train(cfg, w, {"tokens": tokens})
    got, margins = lm_moe_reference.forward(
        w, lm_moe_decode._model(cfg), tokens[0], range(40), qblock=16, with_margins=True)
    assert got.shape == want[0].shape and (margins >= 0).all()
    assert margins.shape == (40, cfg.n_layers - cfg.first_k_dense)
    assert (got - want[0]).abs().max() <= 1e-5 * want.abs().max()


def test_reference_imports_nothing_of_the_program_and_turns_tf32_off():
    code = ("import sys; sys.path[:0] = [%r, %r]; import torch; "
            "torch.backends.cuda.matmul.allow_tf32 = True; torch.backends.cudnn.allow_tf32 = True; "
            "import xmrbench.lm_moe_reference as r; "
            "w = {'embed': torch.ones(5, 4), 'final_norm': torch.ones(4), "
            "'lm_head': torch.ones(4, 5), "
            "'dense_layers': {}, 'layers': {}}; "
            "m = dict(n_layers=0, n_heads=1, qk_nope_dim=2, qk_rope_dim=2, v_head_dim=2, "
            "first_k_dense=0, yarn_factor=40, yarn_mscale_all_dim=0.7); "
            "r.forward(w, m, torch.tensor([1, 2]), [1]); "
            "print(sorted(n for n in sys.modules if n.split('.')[0] == 'repro_torch'), "
            "torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)"
            % (str(ROOT / "src"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False False"


def _hand_model():
    """One dense and one MoE layer, every width 1 but: 2 heads, 4 experts
    top-2, 1 shared expert, vocab 3."""
    return dict(n_layers=2, first_k_dense=1, d_model=1, n_heads=2, kv_lora_rank=1,
                qk_rope_dim=1, qk_nope_dim=1, v_head_dim=1, d_ff=1, vocab=3, n_experts=4,
                experts_per_token=2, moe_d_ff=1, n_shared_experts=1, cache_bytes=4)


def test_moe_work_counts_the_touched_experts_given():
    m = _hand_model()
    assert lm_moe_decode.moe_work(m, 2, 3.0) == lm_moe_decode.moe_work(m, 2)
    assert (lm_moe_decode.moe_work(m, 2, 2.0).nbytes
            == lm_moe_decode.moe_work(m, 2).nbytes - 4 * 3)
    assert (lm_moe_decode.step_work(m, 2, 5, 2.0).moe == lm_moe_decode.moe_work(m, 2, 2.0))


def test_routing_counts_the_programs_distinct_experts():
    """Set-up's reading of the program's routing: at least K and at most
    min(E, T K) distinct experts a layer; a planted router that sends every
    token to the same K experts reads K."""
    cell = _tiny()
    run = lm_moe_decode.setup(cell.config, cell.mix, SEED, 0.3, False, device="cpu")
    e, k = run.cfg.n_experts, run.cfg.experts_per_token
    assert k <= run.touched <= min(e, run.batch * k)
    cache = {key: t.clone() for key, t in run.cache.items()}
    run.w["layers"]["ffn"]["router"].zero_()
    assert run.routing(2) == k
    assert all(torch.equal(t, cache[key]) for key, t in run.cache.items())


def test_router_drift_reads_every_judged_token():
    """xmrbench/router_drift.py on the tiny cell: every judged token read,
    float32 program and reference within 1e-4 of each other's router logits,
    the gaps as the check reads them."""
    from xmrbench import router_drift

    cell = _tiny()
    run = lm_moe_decode.setup(cell.config, cell.mix, SEED, 0.3, False, device="cpu")
    out = router_drift.drift(run)
    assert out["tokens"] == len(run.judge_seqs) * len(run.judge_steps)
    assert 0 < out["widest_drift"] < 1e-4
    assert all(0 <= t["gap"] < 1e-5 and t["margin"] > 0 for t in out["per_token"])


def test_moe_work_by_hand():
    """A batch of 2: the router (4 weights, 2 * 4 FLOPs a token), the
    touched experts 4 (1 - (1 - 2/4)^2) = 3 of 3 weights each, the 2 * 2
    pairs of 2 * 3 FLOPs, the shared expert (3 weights, 2 * 3 FLOPs a
    token)."""
    w = lm_moe_decode.moe_work(_hand_model(), batch=2)
    assert w.nbytes == 4 * (4 + 3 * 3 + 3)
    assert w.flops == 2 * 2 * (4 + 2 * 3 + 3)


def test_step_work_by_hand():
    m = _hand_model()
    w = lm_moe_decode.step_work(m, batch=2, attended=5)
    moe = lm_moe_decode.moe_work(m, batch=2)
    # a layer's attention: wq 4 + wdkv 1 + wkr 1 + wukv 4 + wo 2 = 12; the
    # dense SwiGLU 3; the head 3
    matrices = 2 * 12 + 3 + 3
    attention = 2 * 2 * (2.0 * 2 * 5 * (2 + 1))
    assert w.flops == 2 * 2 * matrices + attention + moe.flops
    # weights and norms (2 + 1 a layer, final 1) in f32, two embedding rows,
    # the MoE's, the f32 latent (2 values) read at 5 positions and written at
    # 1 a sequence and layer, the logits
    assert w.nbytes == 4 * (matrices + 7) + 4 * 2 + moe.nbytes + 4 * 2 * 2 * 2 * 6 + 4 * 2 * 3
    assert w.moe == moe and w.kernel_bytes == 0
    bf16 = lm_moe_decode.step_work(dict(m, cache_bytes=2), batch=2, attended=5)
    assert w.nbytes - bf16.nbytes == 2 * 2 * 2 * 2 * 6


@pytest.mark.parametrize("tokens", [1, 4, 16, 64])
def test_touched_experts_against_brute_force(tokens):
    """E (1 - (1 - K/E)^T) against the distinct experts of seeded routings:
    each token's K distinct experts drawn uniformly, 500 draws."""
    e, k = 64, 6
    g = torch.Generator().manual_seed(tokens)
    counts = [torch.stack([torch.randperm(e, generator=g)[:k] for _ in range(tokens)])
              .unique().numel() for _ in range(500)]
    got = sum(counts) / len(counts)
    assert got == pytest.approx(lm_moe_decode.touched_experts(e, k, tokens), rel=0.02)
    assert lm_moe_decode.touched_experts(e, k, 1) == pytest.approx(k)


def test_run_work_carries_its_moe_part():
    cell = _tiny()
    run = lm_moe_decode.setup(cell.config, cell.mix, SEED, 0.3, False, device="cpu")
    run.begin_window(2)
    w = run.work(2, 5)
    steps = [lm_moe_decode.step_work(run.model, run.batch, run.prompt_len + j + 1, run.touched)
             for j in range(3)]
    assert w.flops == pytest.approx(sum(s.flops for s in steps))
    assert w.moe.nbytes == pytest.approx(3 * steps[0].moe.nbytes)
    assert dataclasses.fields(w)[-1].name == "moe"
