"""The port's LC sandbox (``examples/lc_sandbox_torch.py``) against the JAX
package's ``examples/lc_sandbox.py`` on the CPU: the toy scene's six
rounds of ``lc_process(..., iterations=1, planner="default")``.

The two packages draw the device's hit noise (1%) from different streams
(``PRNGKey(round)`` against a ``torch.Generator`` seeded with the round),
so the curves are held within the sandbox's ``BOUND`` (2e-3 m a
round): JAX prints 3 decimals (5e-4), and the noise moves the port's curve
by under 1e-4 m (this test measures it: noise on against off, within 5e-4
m). The JAX script's printed curve is the sandbox's ``JAX_CURVE``
within the same bound, which the card's curve is held to in
``chip_smoke.py``.
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sandbox_curve_matches_jax(capsys):
    _load("lc_sandbox").main()
    printed = capsys.readouterr().out
    want = [float(x) for x in re.findall(r"mean depth error = ([0-9.]+) m",
                                         printed)]
    assert len(want) == 6
    sandbox = _load("lc_sandbox_torch")
    bound = sandbox.BOUND
    np.testing.assert_allclose(want, sandbox.JAX_CURVE, rtol=0, atol=bound)

    got = sandbox.run("cpu")
    out = capsys.readouterr().out.splitlines()
    assert out == [f"iteration {i + 1}: mean depth error = {e:.3f} m"
                   for i, e in enumerate(got)]
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    assert got[-1] < got[0] and np.all(np.diff(got) < 0)
    quiet = sandbox.run("cpu", hit_noise=0.0, quiet=True)
    assert capsys.readouterr().out == ""
    assert np.abs(np.subtract(got, quiet)).max() <= 5e-4


def test_sandbox_runs_on_the_card_unless_asked():
    import inspect
    sandbox = _load("lc_sandbox_torch")
    assert inspect.signature(sandbox.run).parameters["device"].default == \
        "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            sandbox.main([])
