"""flipped_tpu_torch imports without jax, transitively: the H100 machine the
port runs on need not have it."""
import subprocess
import sys


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import flipped_tpu_torch, flipped_tpu_torch.cli.evaluate\n"
        "import flipped_tpu_torch.model, flipped_tpu_torch.train\n"
        "import flipped_tpu_torch.ckpt, flipped_tpu_torch.utils\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'optax')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
