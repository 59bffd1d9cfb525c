"""Write the deterministic synthetic audio corpus with the PyTorch port (the
counterpart of `scripts/make_synthetic_corpus.py`): the same files, byte for
byte, from `mod_extraction_tpu_torch/data/synthetic.py::
write_synthetic_corpus`.

Usage:
  python scripts/make_synthetic_corpus_torch.py [out_root] [n_train] [n_val] [dur_s] [--style S]
Defaults: data/idmt_4, 32 train and 8 val files of 12 s, style riffs (the
Karplus-Strong guitar riffs; pads, vocal, drums, bass and keys are the
unseen-audio domains).  Files are PCM16 at 44.1 kHz under
`<out_root>/{train,val}`, named `<style>_<seed>_<bpm>bpm.wav`.  Host only:
no card, no kernel.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_argv(argv):
    """(out_root, n_train, n_val, dur_s, style) as the JAX script reads its
    argv: `--style S` anywhere, then positionals."""
    argv = list(argv)
    style = "riffs"
    if "--style" in argv:
        i = argv.index("--style")
        style = argv[i + 1]
        del argv[i : i + 2]
    out_root = argv[0] if len(argv) > 0 else "data/idmt_4"
    n_train = int(argv[1]) if len(argv) > 1 else 32
    n_val = int(argv[2]) if len(argv) > 2 else 8
    dur_s = float(argv[3]) if len(argv) > 3 else 12.0
    return out_root, n_train, n_val, dur_s, style


def main(argv=None) -> None:
    from mod_extraction_tpu_torch.data.synthetic import write_synthetic_corpus

    out_root, n_train, n_val, dur_s, style = parse_argv(sys.argv[1:] if argv is None else argv)
    write_synthetic_corpus(out_root, n_train, n_val, dur_s, style)
    for split, count in (("train", n_train), ("val", n_val)):
        if count > 0:
            print(f"{split} [{style}]: {count} files x {dur_s:.1f}s -> {os.path.join(out_root, split)}")


if __name__ == "__main__":
    main()
