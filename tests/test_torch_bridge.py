"""PyTorch port: parameters carried across from JAX, and the port's imports.

``params_from_jax`` must round-trip the ``init_lm`` pytree (shapes and
values, tied and untied heads) on the dense smoke configs, and the port
(with ``chip_smoke.py``) must import neither JAX nor the JAX package.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config
from repro.models.transformer import init_lm
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import ModelConfig
from repro_torch.models.transformer import init_lm as torch_init_lm

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch,tie", [("qwen1.5-0.5b", True),
                                      ("qwen1.5-0.5b", False),
                                      ("llama3-8b", False),
                                      ("olmo-1b", True)])
def test_params_from_jax_round_trip(arch, tie):
    cfg = dataclasses.replace(get_smoke_config(arch), tie_embeddings=tie)
    params, _ = init_lm(cfg, jax.random.PRNGKey(3))
    host = jax.device_get(params)
    port = params_from_jax(host)
    assert ("head" in port["embed"]) == (not tie)
    want, got = _flat(host), _flat(port)
    assert set(want) == set(got)
    for k in want:
        assert isinstance(got[k], torch.Tensor)
        assert tuple(got[k].shape) == np.shape(want[k]), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = _flat(params_to_numpy(port))
    for k in want:
        np.testing.assert_array_equal(back[k], np.asarray(want[k]))
    # the port's own init draws the same tree shape (other random values)
    own = _flat(torch_init_lm(ModelConfig(**dataclasses.asdict(cfg)),
                              torch.Generator().manual_seed(0), "cpu"))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: np.shape(v) for k, v in want.items()}


def test_params_from_jax_rejects_other_families():
    cfg = get_smoke_config("qwen1.5-0.5b")
    host = jax.device_get(init_lm(cfg, jax.random.PRNGKey(0))[0])
    with pytest.raises(ValueError):
        params_from_jax({k: v for k, v in host.items() if k != "embed"})
    with pytest.raises(ValueError):
        params_from_jax({**host, "shared": host["layers"]})


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "new = {'repro_torch.data.packed', 'repro_torch.kernels.segsum.ops',\n"
        "       'repro_torch.kernels.segsum.ref'}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "assert len(names) >= 23, names\n"
        "print('OK', len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT, env=env)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr
