"""Write preprocessed (dry, wet, mod_sig, fx_params) triplets with the
PyTorch port (the counterpart of `scripts/generate_preproc_datasets.py`),
read back by the `preproc` / `random_preproc` datasets of either package.

The config's data module draws the examples on the host (the port's
`data/modules.py` and `data/loader.py`, seeded by `seed_everything`); each
batch goes to the card and `train/render.py::render_batch` renders its wet
side there (K1, the flanger/chorus delay line, for the `gen_idmt_*`
configs).  For every row the script writes `<h>_dry.wav`, `<h>_wet.wav`
(PCM16) and `<h>.npz` (`mod_sig`, and the row's fx parameters as a pickled
dict `fx_params`), with `h` the first 16 hex digits of the SHA-1 of the dry
row's float32 bytes: the JAX script's layout and names.

Usage:
  python scripts/generate_preproc_datasets_torch.py configs/data/gen_idmt_fl.yml out_dir [n_examples]
      [--device cuda|cpu]
`--device cpu` renders with the kernels' plain versions (slow: a Python
loop over every sample).
"""

import argparse
import hashlib
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def make_loader(cfg, n_examples=None):
    """(data module, train loader) of the config (a path or a loaded dict),
    built as the JAX script builds them: `_filter_kwargs` on the module's
    init args (so keys it takes only through `**kw` are dropped, as in both
    CLIs; ROADMAP.md section 3) and a loader seeded by `seed_everything`."""
    from mod_extraction_tpu_torch.cli import _filter_kwargs, load_yaml_with_includes
    from mod_extraction_tpu_torch.data.loader import Loader
    from mod_extraction_tpu_torch.data.modules import DATA_MODULE_REGISTRY

    if isinstance(cfg, str):
        cfg = load_yaml_with_includes(cfg)
    data_cfg = cfg["data"] if "data" in cfg else cfg
    dm_cls = DATA_MODULE_REGISTRY[data_cfg["class_path"]]
    args = dict(data_cfg.get("init_args") or {})
    if n_examples is not None:
        args["train_num_examples_per_epoch"] = n_examples
    dm = dm_cls(**_filter_kwargs(dm_cls, args))
    dm.setup("fit")
    loader = Loader(dm.train_dataset, dm.batch_size, seed=int(cfg.get("seed_everything", 42)))
    return dm, loader


def to_device(batch: dict, device) -> dict:
    """A loader batch (numpy) as tensors on `device`."""
    from mod_extraction_tpu_torch.train.loop import _tree_map, host_batch_to_torch

    return _tree_map(lambda t: t.to(device), host_batch_to_torch(batch))


def write_triplets(out_dir: str, dry, wet, mod, fx: dict, sr: int) -> list:
    """Each row's `<h>_dry.wav`, `<h>_wet.wav` and `<h>.npz` under
    `out_dir` (numpy inputs); returns the row hashes."""
    from mod_extraction_tpu_torch.data.wav import wav_write

    hashes = []
    for i in range(dry.shape[0]):
        h = hashlib.sha1(dry[i].tobytes()).hexdigest()[:16]
        wav_write(os.path.join(out_dir, f"{h}_dry.wav"), dry[i], sr)
        wav_write(os.path.join(out_dir, f"{h}_wet.wav"), wet[i], sr)
        fx_params = np.array({k: np.asarray(v[i]).item() for k, v in fx.items()}, dtype=object)
        np.savez(os.path.join(out_dir, f"{h}.npz"), mod_sig=mod[i], fx_params=fx_params)
        hashes.append(h)
    return hashes


def generate(cfg, out_dir: str, n_examples=None, device="cuda") -> int:
    """Render and write the config's train examples (`n_examples` of them
    when given) on `device`; returns the count written."""
    import torch

    from mod_extraction_tpu_torch.train.render import render_batch
    from mod_extraction_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    dm, loader = make_loader(cfg, n_examples)
    corpus = dm.corpus_payload()  # None unless device_corpus: true
    if corpus is not None:
        corpus = torch.from_numpy(corpus).to(device)
    os.makedirs(out_dir, exist_ok=True)
    sr = int(dm.render_cfg.sr)
    count = 0
    for batch in loader.epoch(0):
        dry, wet, mod, fx = render_batch(to_device(batch, device), dm.render_cfg, corpus)
        dry, wet, mod = (a.cpu().numpy() for a in (dry, wet, mod))
        count += len(write_triplets(out_dir, dry, wet, mod, {k: v.cpu().numpy() for k, v in fx.items()}, sr))
        print(f"{count} examples written")
    return count


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Write preprocessed triplets rendered on the card.")
    p.add_argument("config", help="data config, e.g. configs/data/gen_idmt_fl.yml")
    p.add_argument("out_dir")
    p.add_argument("n_examples", nargs="?", type=int, default=None,
                   help="examples to write (default: the config's train_num_examples_per_epoch)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    return generate(args.config, args.out_dir, args.n_examples, args.device)


if __name__ == "__main__":
    main()
