"""The port's `run` verb (`python -m ponyc_tpu_torch run [--safe P]
script.py [args]`) and its `--safe` gate (stdlib/pkg.py), the cases of
tests/test_pkg_cli.py: runtime flags stripped and handed to the script's
config.options_from_env, the safe list reaching the program, the usage
errors (exit 2). The script's Runtime() runs on the card unless it asks
for the CPU; without a card it raises, and `run` does not fall back.
`python -m ponyc_tpu_torch` is `main()` (test_torch_cli.py starts it as
a process)."""

import os
import sys
import textwrap

import pytest
import torch

from ponyc_tpu_torch.__main__ import main
from ponyc_tpu_torch.stdlib import pkg


@pytest.fixture
def run(monkeypatch, capsys):
    """`main(["run", ...])` in this process with sys.argv, sys.path and
    the PONY_TPU_* variables it sets restored afterwards; returns (exit
    code, stdout, stderr)."""
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    monkeypatch.setattr(sys, "path", list(sys.path))
    for k in [k for k in os.environ if k.startswith("PONY_TPU_")]:
        monkeypatch.delenv(k)

    def go(*args):
        code = main(["run", *args])
        out = capsys.readouterr()
        return code, out.out, out.err

    yield go
    for k in [k for k in os.environ if k.startswith("PONY_TPU_")]:
        del os.environ[k]
    pkg.set_safe_packages(None)


def _script(tmp_path, body, name="prog.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


RING = """
    import sys
    from ponyc_tpu_torch import RuntimeOptions, options_from_env
    from ponyc_tpu_torch.models import ring
    opts = options_from_env(RuntimeOptions(
        mailbox_cap=4, max_sends=1, msg_words=1, spill_cap=32,
        inject_slots=4, tuning_cache="off"))
    rt = ring.run(16, 40, opts=opts, device="cpu")
    passes = int(rt.cohort_state(ring.RingNode)["passes"].sum())
    print("ARGS", sys.argv[1:], "BATCH", opts.batch, "PASSES", passes)
"""


def test_run_strips_runtime_flags_and_hands_them_to_the_script(run,
                                                               tmp_path):
    code, out, _ = run(_script(tmp_path, RING), "--ponybatch=2",
                       "--input", "x")
    assert code == 0
    assert "ARGS ['--input', 'x'] BATCH 2 PASSES 40" in out


def test_run_safe_flag_reaches_program(run, tmp_path):
    script = _script(tmp_path, """
        from ponyc_tpu_torch.stdlib import pkg
        pkg.use('files')
        try:
            pkg.use('net')
            print('NET_ALLOWED')
        except PermissionError:
            print('NET_BLOCKED')
    """)
    code, out, _ = run("--safe", "files", script)
    assert code == 0 and "NET_BLOCKED" in out
    pkg.set_safe_packages(None)
    code, out, _ = run("--safe=files:net", script)
    assert code == 0 and "NET_ALLOWED" in out


@pytest.mark.parametrize("args,msg", [
    (["x.py", "--safe"], "--safe needs a value"),
    (["--ponybatch", "4"], "missing script path"),
    (["no-such-script.py"], "no such script"),
])
def test_run_usage_errors_exit_2(run, args, msg):
    code, _, err = run(*args)
    assert code == 2 and msg in err


def test_run_never_falls_back_to_the_cpu(run, tmp_path):
    """A script whose Runtime() does not ask for the CPU needs the card."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: Runtime() runs there")
    script = _script(tmp_path, """
        from ponyc_tpu_torch import Runtime, RuntimeOptions
        Runtime(RuntimeOptions())
    """)
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        run(script)
