"""Convert a Hugging Face, Meta or reference Megatron-LM checkpoint into a
release checkpoint, and export one back to an HF directory (the port of the
root tools/convert_hf_checkpoint.py).

  python -m megatron_tpu_torch.tools.convert_hf_checkpoint import \\
      --hf_path Llama-2-7b-hf --out ckpts/llama7b --family llama --size 7b
  python -m megatron_tpu_torch.tools.convert_hf_checkpoint import \\
      --hf_path llama-2-7b --source meta --out ckpts/llama7b
  python -m megatron_tpu_torch.tools.convert_hf_checkpoint import \\
      --hf_path megatron_ckpt --source megatron --out ckpts/llama7b
  python -m megatron_tpu_torch.tools.convert_hf_checkpoint export \\
      --load ckpts/llama7b --hf_out Llama-2-7b-out --family llama

The release checkpoint is the npz format both packages read, written and
read through training/checkpointing.py. HF directories are read and written
by convert/hf_io.py (no `transformers`); the export writes fp32
`pytorch_model.bin` and `config.json`. The architecture of an import is the
`--family/--size` preset (the HF config.json must agree with it), or the
embedded args of a Megatron-LM checkpoint; an export takes the checkpoint's
own config.json (`--size` is not read). The weights pass through the card
unless the caller of `main`, `do_import` or `do_export` names another
device; without a GPU and a device these raise. Mixtral waits for the MoE
model (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

from megatron_tpu_torch.config import (MegatronConfig, ModelConfig,
                                       falcon_config, llama2_config)
from megatron_tpu_torch.utils.device import DeviceLike, resolve_device
from megatron_tpu_torch.utils.logging import print_rank_0

FAMILIES = ("llama", "falcon", "mixtral")

# seconds of the last import and export in this process, for chip_smoke.py:
# {"read_convert_s", "to_device_s", "save_s", "dir"} and {"load_s",
# "convert_s", "write_s", "bytes"}
last_import: dict = {}
last_export: dict = {}


def model_config(family: str, size: str) -> ModelConfig:
    if family == "llama":
        return llama2_config(size)
    if family == "falcon":
        return falcon_config(size)
    if family == "mixtral":
        raise NotImplementedError(
            "--family mixtral: Mixtral conversion waits for the MoE model "
            "(models/moe.py, ROADMAP Queue 1 item 8)")
    raise ValueError(f"unknown family {family!r}")


def _check_family(family: str) -> None:
    if family == "mixtral":
        model_config(family, "8x7b")  # raises, naming the Queue 1 item


def read_hf_params(path: str, family: str, cfg: ModelConfig) -> dict:
    """The parameter tree of the HF directory `path` (config.json checked
    against `cfg`), read one tensor at a time."""
    from megatron_tpu_torch.convert import hf, hf_io
    hf_io.check_hf_config(hf_io.read_hf_config(path), cfg, family)
    conv = {"llama": hf.hf_llama_to_params,
            "falcon": hf.hf_falcon_to_params}[family]
    with hf_io.HFStateDict(path) as sd:
        return conv(sd, cfg)


def do_import(args, cfg: Optional[ModelConfig] = None, *,
              device: DeviceLike = None):
    """`args.hf_path` (source `args.source`) -> a release checkpoint under
    `args.out`. Returns (checkpoint dir, the imported LanguageModel on
    `device`)."""
    from megatron_tpu_torch.convert import megatron, meta
    from megatron_tpu_torch.convert.from_jax import params_from_numpy
    from megatron_tpu_torch.models.language_model import LanguageModel
    from megatron_tpu_torch.training import checkpointing as ckpt
    from megatron_tpu_torch.training.train_step import TrainState

    device = resolve_device(device)
    if args.source != "megatron":
        _check_family(args.family)
    t0 = time.perf_counter()
    if args.source == "megatron":
        print_rank_0(f"loading reference Megatron-LM checkpoint from "
                     f"{args.hf_path}")
        sd, ref_args, info = megatron.load_megatron_checkpoint(args.hf_path)
        print_rank_0(f"  iteration={info['iteration']} version="
                     f"{info['checkpoint_version']} tp={info['tp']} "
                     f"pp={info['pp']}")
        cfg = cfg or megatron.config_from_megatron_args(ref_args)
        params = megatron.megatron_to_params(sd, cfg)
        del sd
    else:
        cfg = cfg or model_config(args.family, args.size)
        if args.source == "meta":
            if args.family != "llama":
                raise ValueError("the Meta format is Llama's only")
            print_rank_0(f"merging Meta shards from {args.hf_path}")
            params = meta.meta_llama_to_params(
                meta.merge_meta_llama(args.hf_path), cfg)
        else:
            print_rank_0(f"reading HF checkpoint from {args.hf_path}")
            params = read_hf_params(args.hf_path, args.family, cfg)
    t1 = time.perf_counter()
    model = LanguageModel.from_state_dict(
        cfg, params_from_numpy(params, cfg, device))
    del params
    t2 = time.perf_counter()
    d = ckpt.save_checkpoint(args.out, TrainState(model, None, 0),
                             MegatronConfig(model=cfg), iteration=0,
                             release=True)
    last_import.clear()
    last_import.update(read_convert_s=t1 - t0, to_device_s=t2 - t1,
                       save_s=time.perf_counter() - t2, dir=d)
    print_rank_0(f"wrote release checkpoint {d}")
    return d, model


class _DeviceLeaf:
    """A parameter left where the model holds it (the card). Indexing copies
    one layer of a stacked [L, ...] leaf to the host and np.asarray copies
    the whole leaf, so the converters build the HF state dict a layer at a
    time and an export holds one host copy of the model, as an import
    does."""

    def __init__(self, tensor):
        self.tensor = tensor

    def __getitem__(self, i):
        return self.tensor[i].cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.tensor.cpu().numpy()
        return a if dtype is None else a.astype(dtype, copy=False)


def do_export(args, cfg: Optional[ModelConfig] = None, *,
              device: DeviceLike = None) -> str:
    """The checkpoint under `args.load` -> an HF directory `args.hf_out`
    in `args.family`'s layout. The architecture is `cfg`, else the
    checkpoint's config.json. The model is loaded onto `device` and its
    leaves are copied back a layer at a time as they are converted."""
    from megatron_tpu_torch.convert import hf, hf_io
    from megatron_tpu_torch.convert.from_jax import load_npz_checkpoint
    from megatron_tpu_torch.models.language_model import params_tree

    _check_family(args.family)
    t0 = time.perf_counter()
    model, saved = load_npz_checkpoint(args.load, device)
    cfg = cfg or saved
    tree = params_tree({k: _DeviceLeaf(t.detach())
                        for k, t in model.state_dict().items()})
    t1 = time.perf_counter()
    conv = {"llama": hf.params_to_hf_llama,
            "falcon": hf.params_to_hf_falcon}[args.family]
    sd = conv(tree, cfg)
    del tree, model
    t2 = time.perf_counter()
    path = hf_io.save_hf_checkpoint(args.hf_out, sd,
                                    hf_io.hf_config_dict(cfg, args.family))
    last_export.clear()
    last_export.update(load_s=t1 - t0, convert_s=t2 - t1,
                       write_s=time.perf_counter() - t2,
                       bytes=os.path.getsize(path))
    print_rank_0(f"wrote HF checkpoint to {args.hf_out}")
    return args.hf_out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("import")
    pi.add_argument("--hf_path", required=True,
                    help="HF checkpoint directory, a directory of "
                         "consolidated.NN.pth shards with --source meta, or "
                         "a Megatron-LM checkpoint root with --source "
                         "megatron")
    pi.add_argument("--out", required=True)
    pi.add_argument("--family", default="llama", choices=FAMILIES)
    pi.add_argument("--size", default="7b")
    pi.add_argument("--source", default="hf",
                    choices=["hf", "meta", "megatron"],
                    help="meta = raw Meta Llama consolidated shards; "
                         "megatron = reference iter_N/mp_rank_XX layout "
                         "(tp/pp shards merged, architecture from the "
                         "embedded args)")
    pe = sub.add_parser("export")
    pe.add_argument("--load", required=True)
    pe.add_argument("--hf_out", required=True)
    pe.add_argument("--family", default="llama", choices=FAMILIES)
    pe.add_argument("--size", default="7b")
    return p.parse_args(argv)


def main(argv=None, *, device: DeviceLike = None) -> int:
    args = parse_args(argv)
    if args.cmd == "import":
        do_import(args, device=device)
    else:
        do_export(args, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
