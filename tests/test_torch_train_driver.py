"""Twins of the reference's training-driver tests
(``tests/test_launch_tools.py``): the port's ``launch.train.main`` on the
``tiny`` preset on the CPU, where the loss must drop by 0.2 over 100
steps, and a run resumed from its checkpoint at step 20 must run the 10
steps left; and a resumed run's losses equal the straight run's, bit for
bit (the step-indexed pipeline and a bit-exact restore).  ``main(argv,
cfg=)`` trains a variant config (the reduced mamba2-130m)."""
import numpy as np
import torch

from repro_torch.launch import train

torch.set_num_threads(2)


def test_train_driver_loss_drops():
    losses = train.main(["--preset", "tiny", "--steps", "100", "--batch",
                         "4", "--seq", "64", "--lr", "3e-3", "--log-every",
                         "100", "--device", "cpu"])
    assert len(losses) == 100
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.2


def test_train_driver_resume(tmp_path):
    d = str(tmp_path / "ck")
    args = ["--preset", "tiny", "--batch", "2", "--seq", "32",
            "--ckpt-every", "10", "--log-every", "100", "--device", "cpu"]
    l1 = train.main(["--steps", "20", "--ckpt-dir", d] + args)
    # resume continues from the step-20 checkpoint: 10 more steps
    l2 = train.main(["--steps", "30", "--ckpt-dir", d] + args)
    assert len(l1) == 20 and len(l2) == 10


def test_train_driver_resume_is_bit_exact(tmp_path):
    """A 30-step run whose last checkpoint (step 29) is lost resumes from
    step 19 and gives the straight run's last 10 losses bit for bit."""
    d = tmp_path / "ck"
    args = ["--preset", "tiny", "--steps", "30", "--batch", "2", "--seq",
            "32", "--log-every", "100", "--device", "cpu"]
    straight = train.main(args + ["--ckpt-dir", str(d), "--ckpt-every",
                                  "10"])
    for f in d.glob("step_00000029.*"):
        f.unlink()
    resumed = train.main(args + ["--ckpt-dir", str(d), "--ckpt-every",
                                 "10"])
    assert len(straight) == 30 and resumed == straight[20:]


def test_train_driver_takes_a_variant_config():
    """``main(argv, cfg=)`` trains a config in place of ``--arch``'s: the
    reduced mamba2-130m on the CPU, through the plain SSD's gradients;
    the same steps from the same seed give the same losses."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-130m").reduced()
    args = ["--steps", "3", "--batch", "2", "--seq", "32", "--log-every",
            "10", "--device", "cpu"]
    losses = train.main(args, cfg=cfg)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert train.main(args, cfg=cfg) == losses
