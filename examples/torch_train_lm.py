"""End-to-end training on the PyTorch port (the twin of
``examples/train_lm.py``): train an LM on the synthetic pipeline through
``repro_torch.launch.train.main`` and check the loss drops.  The printed
judgement is the reference's ("OK: learning" below 0.8 of the first ten
steps' mean loss, else "WARN: flat"); the exit code is 0 where the last
ten steps' mean is below the first ten's.  Runs on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_train_lm.py     # tiny, 200 steps
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.train import main as train  # noqa: E402


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    rest = list(argv)
    if "--device" in rest:
        del rest[rest.index("--device"):rest.index("--device") + 2]
    if not rest:     # the reference's default run
        argv = ["--preset", "tiny", "--steps", "200", "--ckpt-dir",
                tempfile.mkdtemp(prefix="repro_torch_train_lm_")] + argv
    losses = train(argv)
    first = sum(losses[:10]) / 10
    last = sum(losses[-10:]) / 10
    print(f"\nloss {first:.3f} → {last:.3f} "
          f"({'OK: learning' if last < 0.8 * first else 'WARN: flat'})")
    return 0 if last < first else 1


if __name__ == "__main__":
    sys.exit(main())
