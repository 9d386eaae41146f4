"""Correctness gate of the port against pinned fixtures (the port of the root
verify_correctness.py).

The reference's verify_correctness.py runs Megatron beside a trusted
baseline (HF or Meta) on the same batches and reports the max-abs logit
error and the loss delta, held at an average max-abs of 1e-3 in fp32. The
port has the same comparison as a function, `compare_llama(hf_model, cfg,
tokens)`, for a caller that holds an HF model (the CPU tests build one with
`transformers`, which the card's machine lacks). Its command line runs the
two gates that need no `transformers`, each against a fixture the JAX
package committed under tests/fixtures/:

- golden logits (`--golden`): the numpy-seeded synthetic Llama (4 layers,
  hidden 64, 4/2 heads, ffn 176, vocab 128) is rebuilt as an HF state dict
  from the pinned, ordered list of `LlamaForCausalLM.state_dict()` names
  and shapes (`synthetic_hf_llama_names`), filled as the root tool's
  `seed_hf_llama_numpy` fills it, converted by convert/hf.py and run in
  fp32; tokens [2, 64] must equal the fixture's and the logits [2, 64, 128]
  agree at an average max-abs <= 1e-3;
- the loss trajectory (`--loss_trajectory`): 100 steps of
  `make_train_step` (Adam, clipping, warmup + cosine lr, weight decay, the
  dynamic fp16 loss scaler) on the same model over a fixed 4-batch cycle,
  in fp32 and in fp16, each series held to JAX's tolerances (fp32 losses
  rtol 2e-4 / atol 1e-5, lr rtol 1e-6, grad norm rtol 1e-3 / atol 1e-5;
  fp16 loss scale and found_inf exact, the applied steps' losses rtol
  1e-2 / atol 1e-3). The fp32 losses and lr gate the exit code
  (`GATED`); the other series are printed as reported. A free run holds
  them only on a bit-identical backend: JAX's own fp32 run with one weight
  moved by one ulp leaves the grad norm's rtol 1e-3 late in the run, and
  in fp16 one rounding apart changes the step at which the scaler next
  overflows, after which the sequences part. tests/test_torch_verify.py
  holds every series at every step teacher-forced from JAX's state.

  python -m megatron_tpu_torch.verify_correctness \\
      --golden tests/fixtures/golden_logits_llama_synthetic.npz \\
      --loss_trajectory tests/fixtures/golden_loss_trajectory.npz

It runs on the card unless `main(argv, device=...)` names another device;
without a GPU and a device it raises. Matmuls run in full fp32 (TF32 off,
PyTorch's default for matmul). The synthetic model's head dim is 16, so its
attention takes the dot path and launches no kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from megatron_tpu_torch.config import (MegatronConfig, ModelConfig,
                                       OptimizerConfig, TrainingConfig)
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device

# the synthetic Llama of both fixtures
SYNTHETIC = dict(vocab=128, hidden=64, layers=4, heads=4, kv=2, ffn=176,
                 seq=64)
GOLDEN_TOL = 1e-3  # the reference CI gate, average max-abs in fp32
TRAJECTORY_MODES = ("fp32", "fp16")
# the trajectory series a free run holds on any backend (module docstring)
GATED = frozenset({"fp32 losses", "fp32 lr"})

# LlamaForCausalLM.state_dict() order (transformers 4.57; the rotary
# inv_freq buffer is non-persistent and not in it): one layer's names
_LLAMA_LAYER_NAMES = (
    ("self_attn.q_proj.weight", ("q", "h")),
    ("self_attn.k_proj.weight", ("kv", "h")),
    ("self_attn.v_proj.weight", ("kv", "h")),
    ("self_attn.o_proj.weight", ("h", "q")),
    ("mlp.gate_proj.weight", ("ffn", "h")),
    ("mlp.up_proj.weight", ("ffn", "h")),
    ("mlp.down_proj.weight", ("h", "ffn")),
    ("input_layernorm.weight", ("h",)),
    ("post_attention_layernorm.weight", ("h",)),
)


def synthetic_hf_llama_names(vocab=128, hidden=64, layers=4, heads=4, kv=2,
                             ffn=176) -> list:
    """[(name, shape)] of an untied LlamaForCausalLM's state_dict, in its
    order."""
    hd = hidden // heads
    dims = {"h": hidden, "q": heads * hd, "kv": kv * hd, "ffn": ffn}
    out = [("model.embed_tokens.weight", (vocab, hidden))]
    for i in range(layers):
        out += [(f"model.layers.{i}.{name}", tuple(dims[d] for d in shape))
                for name, shape in _LLAMA_LAYER_NAMES]
    out += [("model.norm.weight", (hidden,)),
            ("lm_head.weight", (vocab, hidden))]
    return out


def synthetic_config(vocab=128, hidden=64, layers=4, heads=4, kv=2, ffn=176,
                     seq=64) -> ModelConfig:
    """The ModelConfig of the synthetic Llama (fp32 compute)."""
    return ModelConfig(
        num_layers=layers, hidden_size=hidden, num_attention_heads=heads,
        num_kv_heads=kv, ffn_hidden_size=ffn, vocab_size=vocab,
        make_vocab_size_divisible_by=1, seq_length=seq,
        activation="swiglu", norm_type="rmsnorm", use_rotary_emb=True,
        use_bias=False, tie_embed_logits=False,
        compute_dtype="float32").derived()


def seed_hf_llama_numpy_sd(names, seed: int = 0) -> dict:
    """The values the root verify_correctness.seed_hf_llama_numpy gives an
    HF model with these (name, shape) in its state_dict order: one
    `default_rng(seed)` stream, norm gains 1 + 0.02 N, everything else
    0.02 N, as fp32."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in names:
        if name.endswith("norm.weight"):
            arr = 1.0 + 0.02 * rng.standard_normal(shape)
        else:
            arr = 0.02 * rng.standard_normal(shape)
        sd[name] = arr.astype(np.float32)
    return sd


def synthetic_llama_sd(seed: int = 0) -> dict:
    """The golden fixtures' HF state dict, with no `transformers`."""
    dims = {k: v for k, v in SYNTHETIC.items() if k != "seq"}
    return seed_hf_llama_numpy_sd(synthetic_hf_llama_names(**dims), seed)


def _model(sd: dict, cfg: ModelConfig, device: torch.device,
           trainable: bool = False):
    from megatron_tpu_torch.convert.from_jax import params_from_numpy
    from megatron_tpu_torch.convert.hf import hf_llama_to_params
    from megatron_tpu_torch.models.language_model import LanguageModel
    return LanguageModel.from_state_dict(
        cfg, params_from_numpy(hf_llama_to_params(sd, cfg), cfg, device),
        trainable=trainable)


def compare_llama(hf_model, cfg: ModelConfig, tokens: np.ndarray, *,
                  device: DeviceLike = None) -> dict:
    """Run the HF model (torch, fp32, on the CPU) and the port's
    LanguageModel converted from it (fp32, on `device`) on `tokens`
    [b, s]. Returns {max_abs_err, avg_max_abs_err, loss_ours, loss_hf}."""
    from megatron_tpu_torch.models.language_model import model_forward
    from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss

    device = resolve_device(device)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    sd = {k: v.detach().cpu().float().numpy()
          for k, v in hf_model.state_dict().items()}
    model = _model(sd, cfg, device)
    toks = torch.from_numpy(np.asarray(tokens, np.int64))
    with torch.no_grad():
        out = hf_model(toks).logits.float().numpy()
        logits, _ = model_forward(model, toks.to(device), cfg)
    ours = logits.cpu().numpy()[..., :cfg.vocab_size]
    abs_err = np.abs(ours - out)
    labels = toks[:, 1:]
    loss_ours = cross_entropy_loss(torch.from_numpy(ours[:, :-1]), labels,
                                   vocab_size=cfg.vocab_size).mean()
    loss_hf = torch.nn.functional.cross_entropy(
        torch.from_numpy(out[:, :-1]).reshape(-1, out.shape[-1]),
        labels.reshape(-1))
    return {"max_abs_err": float(abs_err.max()),
            "avg_max_abs_err": float(abs_err.max(axis=-1).mean()),
            "loss_ours": float(loss_ours), "loss_hf": float(loss_hf)}


def golden_logits(batch: int = 2, device: DeviceLike = None):
    """(tokens [batch, 64] int32, fp32 logits [batch, 64, 128]) of the
    numpy-seeded synthetic Llama through convert/hf.py and the port's
    model."""
    from megatron_tpu_torch.models.language_model import model_forward

    device = resolve_device(device)
    cfg = synthetic_config(**SYNTHETIC)
    model = _model(synthetic_llama_sd(0), cfg, device)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size,
                          (batch, SYNTHETIC["seq"])).astype(np.int32)
    with torch.no_grad():
        logits, _ = model_forward(
            model, torch.from_numpy(tokens.astype(np.int64)).to(device), cfg)
    return tokens, logits.cpu().numpy()[..., :cfg.vocab_size]


def golden_mode(path: str, tolerance: float = GOLDEN_TOL,
                device: DeviceLike = None) -> dict:
    """Replay the golden-logit fixture: {"avg_max_abs_err", "ok"}."""
    pinned = np.load(path)
    tokens, ours = golden_logits(pinned["tokens"].shape[0], device)
    if not np.array_equal(pinned["tokens"], tokens):
        raise AssertionError("fixture tokens differ: the numpy Generator "
                             "stream changed?")
    err = float(np.abs(ours - pinned["logits"]).max(-1).mean())
    print(f"avg max-abs vs golden: {err:.2e} "
          f"({'PASS' if err <= tolerance else 'FAIL'}, tolerance "
          f"{tolerance:.0e})")
    return {"avg_max_abs_err": err, "ok": err <= tolerance}


def trajectory_config(steps: int, mode: str) -> MegatronConfig:
    """The fixture's run: fp32 or fp16 compute, Adam with clipping, warmup
    then cosine decay, weight decay, and (fp16) a loss scale that starts
    above fp16's range so that the scaler must back off, then grow."""
    mcfg = dataclasses.replace(
        synthetic_config(**SYNTHETIC),
        compute_dtype="float32" if mode == "fp32" else "float16")
    return MegatronConfig(
        model=mcfg,
        optimizer=OptimizerConfig(
            lr=3e-3, min_lr=3e-4, lr_decay_style="cosine",
            lr_decay_iters=steps, lr_warmup_iters=10, weight_decay=0.1,
            clip_grad=1.0, initial_loss_scale=2.0 ** 24,
            loss_scale_window=25, hysteresis=2),
        training=TrainingConfig(micro_batch_size=2, global_batch_size=2,
                                train_iters=steps)).validate()


def run_loss_trajectory(steps: int = 100, mode: str = "fp32",
                        device: DeviceLike = None) -> dict:
    """`steps` train steps of the synthetic Llama over a fixed cycle of 4
    batches (fresh random tokens would keep the loss at ln V; a cycle lets
    Adam descend). Returns {losses, lr, grad_norm, loss_scale, found_inf}
    as numpy arrays of length `steps`."""
    from megatron_tpu_torch.training import make_train_step
    from megatron_tpu_torch.training.train_step import state_from_params

    device = resolve_device(device)
    cfg = trajectory_config(steps, mode)
    state = state_from_params(
        _model(synthetic_llama_sd(0), cfg.model, device, trainable=True),
        cfg)
    step = make_train_step(cfg, device=device)
    data_rng = np.random.default_rng(1)
    cycle = [torch.from_numpy(data_rng.integers(
        0, cfg.model.vocab_size, (1, 2, 65)).astype(np.int64)).to(device)
        for _ in range(4)]
    mask = torch.ones(1, 2, 64, dtype=torch.float32, device=device)
    metrics = []
    for i in range(steps):
        state, m = step(state, {"tokens": cycle[i % 4], "loss_mask": mask})
        metrics.append({k: m[k] for k in ("lm_loss", "lr", "grad_norm",
                                          "loss_scale", "found_inf")})
    out = {k: [] for k in ("losses", "lr", "grad_norm", "loss_scale",
                           "found_inf")}
    for m in metrics:  # read back once the steps are queued
        out["losses"].append(float(m["lm_loss"]))
        out["lr"].append(float(m["lr"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["loss_scale"].append(float(m["loss_scale"]))
        out["found_inf"].append(float(m["found_inf"]))
    return {k: np.asarray(v) for k, v in out.items()}


def check_trajectory(got: dict, pinned, mode: str) -> list:
    """The fixture's tolerances, as the JAX package holds them. Returns
    [(series, ok, max abs deviation, gated)]; `gated` marks the series in
    GATED, the rest are reported."""
    rows = []

    def check(name, a, b, rtol, atol=0.0, exact=False):
        ok = (np.array_equal(a, b) if exact
              else np.allclose(a, b, rtol=rtol, atol=atol))
        worst = float(np.max(np.abs(a - b))) if len(a) else 0.0
        series = f"{mode} {name}"
        rows.append((series, bool(ok), worst, series in GATED))

    if mode == "fp32":
        check("losses", got["losses"], pinned["fp32_losses"], 2e-4, 1e-5)
        check("lr", got["lr"], pinned["fp32_lr"], 1e-6)
        check("grad_norm", got["grad_norm"], pinned["fp32_grad_norm"],
              1e-3, 1e-5)
    else:
        check("loss_scale", got["loss_scale"], pinned["fp16_loss_scale"],
              0, exact=True)
        check("found_inf", got["found_inf"], pinned["fp16_found_inf"], 0,
              exact=True)
        applied = pinned["fp16_found_inf"] == 0
        check("losses(applied)", got["losses"][applied],
              pinned["fp16_losses"][applied], 1e-2, 1e-3)
    return rows


def trajectory_mode(path: str, device: DeviceLike = None) -> dict:
    """Replay the loss-trajectory fixture in each of TRAJECTORY_MODES:
    {"rows", "ok"}, `ok` when every gated series holds."""
    pinned = np.load(path)
    steps = int(pinned["steps"])
    rows = []
    for mode in TRAJECTORY_MODES:
        rows += check_trajectory(run_loss_trajectory(steps, mode, device),
                                 pinned, mode)
    for name, ok, worst, gated in rows:
        print(f"  {name:<22} {'PASS' if ok else 'FAIL'} (max abs dev "
              f"{worst:.3e}{'' if gated else ', reported'})")
    ok = all(r[1] for r in rows if r[3])
    print("PASS" if ok else "FAIL")
    return {"rows": rows, "ok": ok}


def main(argv=None, *, device: DeviceLike = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--golden", type=str, default=None,
                   help="golden-logit fixture (.npz) to replay")
    p.add_argument("--loss_trajectory", type=str, default=None,
                   help="loss-trajectory fixture (.npz) to replay")
    p.add_argument("--tolerance", type=float, default=GOLDEN_TOL)
    args = p.parse_args(argv)
    if not args.golden and not args.loss_trajectory:
        p.error("give --golden and/or --loss_trajectory (a comparison "
                "against an HF model runs through compare_llama)")
    device = resolve_device(device)
    ok = True
    if args.golden:
        ok &= golden_mode(args.golden, args.tolerance, device)["ok"]
    if args.loss_trajectory:
        ok &= trajectory_mode(args.loss_trajectory, device)["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
