"""Checkpoints across the two packages, and the port's fault-tolerant
runner. A tree with a bf16 leaf, fp32 leaves, the int32 step count and a
quantized leaf (W4A16 with zero-points, its format sidecar) saved by
either package restores in the other bit for bit, under the same key
strings; restoring into a mismatched template fails with the JAX
package's messages. The runner passes the JAX package's three
``tests/test_resilient.py`` scenarios."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.core import quant as jquant

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import from_jax_params, to_tensor
from repro_torch.core import quant as tquant
from repro_torch.core.tree import tree_flatten_with_keys
from repro_torch.runtime.resilient import RunnerConfig, run_training

from torch_parity_helpers import jax_to_numpy


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    return {
        "params": {
            "embed": {"table": rng.standard_normal((16, 8))
                      .astype(np.float32)},
            "layers": {"w": {"kernel": w}},
            "final_norm": {"scale": rng.standard_normal(8)
                           .astype(np.float32)},
        },
        "opt": {"m": {"scale": rng.standard_normal(8).astype(np.float32)},
                "count": np.int32(7 + seed)},
    }


def _jax_tree(t, fmt="w4a16_g128"):
    """bf16 table, the kernel quantized (asymmetric W4A16 or ``fmt``)."""
    p = t["params"]
    qt = jquant.quantize(jnp.asarray(p["layers"]["w"]["kernel"]), fmt,
                         symmetric=False, out_dtype=jnp.bfloat16)
    return {"params": {"embed": {"table": jnp.asarray(p["embed"]["table"],
                                                      jnp.bfloat16)},
                       "layers": {"w": {"kernel": qt}},
                       "final_norm": {"scale": jnp.asarray(
                           p["final_norm"]["scale"])}},
            "opt": {"m": {"scale": jnp.asarray(t["opt"]["m"]["scale"])},
                    "count": jnp.asarray(t["opt"]["count"])}}


def _port_tree(jtree):
    """The same tree in the port's types (bits and format carried)."""
    n = jax_to_numpy(jtree)
    p = n["params"]
    return {"params": {
        "embed": {"table": to_tensor(p["embed"]["table"])},
        "layers": {"w": {"kernel": from_jax_params(
            p["layers"]["w"]["kernel"], dtype=torch.bfloat16)}},
        "final_norm": {"scale": to_tensor(p["final_norm"]["scale"])}},
        "opt": {"m": {"scale": to_tensor(n["opt"]["m"]["scale"])},
                "count": to_tensor(n["opt"]["count"])}}


def _assert_same(tree, jtree):
    """Leaf for leaf, bit for bit (bf16 through its bits), same formats,
    against the JAX tree in the port's types."""
    got = dict(tree_flatten_with_keys(tree))
    want = dict(tree_flatten_with_keys(_port_tree(jtree)))
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, tquant.QuantizedTensor):
            assert isinstance(g, tquant.QuantizedTensor)
            assert g.format == w.format and g.group_size == w.group_size
            assert g.out_dtype == w.out_dtype == torch.bfloat16
            for f in ("packed", "scales", "zeros"):
                assert torch.equal(getattr(g, f), getattr(w, f)), (key, f)
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert torch.equal(g, w), key


def _zeros_like(tree):
    """A restore template: the same structure, shapes, dtypes, formats."""
    def z(x):
        if isinstance(x, dict):
            return {k: z(v) for k, v in x.items()}
        if isinstance(x, tquant.QuantizedTensor):
            return tquant.QuantizedTensor(
                torch.zeros_like(x.packed), torch.zeros_like(x.scales),
                None if x.zeros is None else torch.zeros_like(x.zeros),
                x.group_size, x.out_dtype, x.format)
        return torch.zeros_like(x)
    return z(tree)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jtree = _jax_tree(_numpy_tree())
    jsave(str(tmp_path), 5, jtree, extra={"note": "jax"})
    like = _zeros_like(_port_tree(_jax_tree(_numpy_tree(seed=1))))
    tree, step, extra = restore_checkpoint(str(tmp_path), like)
    assert step == 5 and extra == {"note": "jax"}
    _assert_same(tree, jtree)


def test_port_checkpoint_restores_in_jax_with_the_same_keys(tmp_path):
    jtree = _jax_tree(_numpy_tree())
    save_checkpoint(str(tmp_path / "port"), 3, _port_tree(jtree),
                    extra={"note": "port"})
    jsave(str(tmp_path / "jax"), 3, jtree, extra={"note": "port"})
    like = _jax_tree(_numpy_tree(seed=1))
    got, step, extra = jrestore(str(tmp_path / "port"), like)
    assert step == 3 and extra == {"note": "port"}
    _assert_same(_port_tree(got), jtree)
    # the two packages write the same keys and the same sidecars
    metas, keys = [], []
    for d in ("port", "jax"):
        root = tmp_path / d / "step_3"
        metas.append(json.loads((root / "meta.json").read_text()))
        with np.load(root / "arrays.npz") as z:
            keys.append(sorted(z.files))
    assert metas[0] == metas[1] and keys[0] == keys[1]
    assert "params/layers/w/kernel/__zeros" in keys[0]
    assert "opt/count" in keys[0]
    assert latest_step(str(tmp_path / "port")) == 3


# one REDUCED arch of each family, and a leaf only that family's tree holds
FAMILY_LEAVES = {
    "olmoe-1b-7b": "params/layers/moe/w_gate/kernel",
    "rwkv6-7b": "params/layers/w_bias",
    "hymba-1.5b": "params/layers/ssm/A_log",
    "whisper-small": "params/encoder/layers/attn/wq/kernel",
    "internvl2-1b": "params/lm_head/kernel",
}


def _train_trees(arch, seed):
    """A train checkpoint's tree ({"params", "opt"}) of REDUCED ``arch``
    from JAX's ``init_params`` at ``seed``: JAX's, and the port's
    converted leaf for leaf."""
    import jax
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro.optim import AdamWConfig, adamw_init
    from repro_torch import configs
    from repro_torch.convert import from_jax_opt_state
    jcfg = jconfigs.get_reduced(arch)
    params = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jtree = {"params": params, "opt": adamw_init(params, AdamWConfig())}
    n = jax_to_numpy(jtree)
    return jtree, {"params": from_jax_params(
        n["params"], dtype=configs.get_reduced(arch).dtype),
        "opt": from_jax_opt_state(n["opt"])}


def _assert_bits(got, want):
    got, want = dict(tree_flatten_with_keys(got)), \
        dict(tree_flatten_with_keys(want))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype and torch.equal(got[key], w), key


@pytest.mark.parametrize("arch", sorted(FAMILY_LEAVES))
def test_family_train_checkpoint_round_trip(arch, tmp_path):
    """A train checkpoint of each family's REDUCED tree (MoE expert
    stacks, rwkv's fp32 ``w_bias``, hymba's ``A_log`` and ``D``, the
    encoder subtree) saved by JAX restores in the port bit for bit, and
    the port's restores in JAX; both packages write the same keys."""
    jtree, ttree = _train_trees(arch, 0)
    jlike, tlike = _train_trees(arch, 1)
    jsave(str(tmp_path / "jax"), 2, jtree)
    got, step, _ = restore_checkpoint(str(tmp_path / "jax"), tlike)
    assert step == 2
    _assert_bits(got, ttree)
    save_checkpoint(str(tmp_path / "port"), 2, ttree)
    back, step, _ = jrestore(str(tmp_path / "port"), jlike)
    assert step == 2
    got, want = (dict(tree_flatten_with_keys(jax_to_numpy(t)))
                 for t in (back, jtree))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype and np.array_equal(got[key], w), key
    keys = []
    for d in ("port", "jax"):
        with np.load(tmp_path / d / "step_2" / "arrays.npz") as z:
            keys.append(sorted(z.files))
    assert keys[0] == keys[1] and FAMILY_LEAVES[arch] in keys[0]
    assert "opt/m/" + FAMILY_LEAVES[arch].split("/", 1)[1] in keys[0]


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_mismatches_fail_with_the_jax_messages(tmp_path):
    jtree = _jax_tree(_numpy_tree())
    jsave(str(tmp_path), 1, jtree)
    ptree = _port_tree(jtree)
    cases = []
    # a shape mismatch
    jbad = dict(jtree, opt={"m": {"scale": jnp.zeros(9)},
                            "count": jtree["opt"]["count"]})
    pbad = dict(ptree, opt={"m": {"scale": torch.zeros(9)},
                            "count": ptree["opt"]["count"]})
    cases.append((jbad, pbad))
    # another quantization format
    jq = _jax_tree(_numpy_tree(), fmt="w8a16_channel")
    cases.append((jq, _port_tree(jq)))
    # a dense template where a quantized leaf was saved
    jd = _jax_tree(_numpy_tree())
    jd["params"]["layers"]["w"]["kernel"] = jnp.zeros((256, 64),
                                                      jnp.bfloat16)
    pd = _port_tree(_jax_tree(_numpy_tree()))
    pd["params"]["layers"]["w"]["kernel"] = torch.zeros(
        256, 64, dtype=torch.bfloat16)
    cases.append((jd, pd))
    for jlike, plike in cases:
        want = _error(lambda: jrestore(str(tmp_path), jlike))
        got = _error(lambda: restore_checkpoint(str(tmp_path),
                                                _zeros_like(plike)))
        assert got == want
    # a quantized template where a dense leaf was saved
    jsave(str(tmp_path / "dense"), 1, jd)
    save_checkpoint(str(tmp_path / "pdense"), 1, pd)
    want = _error(lambda: jrestore(str(tmp_path / "dense"), jtree))
    got = _error(lambda: restore_checkpoint(str(tmp_path / "pdense"),
                                            _zeros_like(ptree)))
    assert got == want and "expects a quantized" in got


# ---------------------------------------------------------------------------
# the runner: the scenarios of tests/test_resilient.py
# ---------------------------------------------------------------------------

def _setup():
    params = {"w": torch.zeros(4)}
    opt = {"m": torch.zeros(4)}

    def train_step(params, opt, inputs):
        p = {"w": params["w"] + 1.0}
        return p, opt, {"loss": torch.sum(p["w"])}

    return params, opt, train_step, lambda step: {"step": step}


def test_transient_failures_are_retried(tmp_path):
    params, opt, step_fn, batches = _setup()
    boom = {"left": 2}

    def inject(step, retries):
        if step == 3 and boom["left"] > 0:
            boom["left"] -= 1
            return True
        return False

    p, _, hist = run_training(
        cfg=RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                         max_retries=3),
        train_step=step_fn, params=params, opt_state=opt, batches=batches,
        num_steps=6, inject_failure=inject)
    kinds = [h[0] for h in hist]
    assert kinds.count("failure") == 2 and "restart" not in kinds
    assert float(p["w"][0]) == 6.0


def test_hard_failure_restores_checkpoint_and_remeshes(tmp_path):
    params, opt, step_fn, batches = _setup()
    remeshed = {"n": 0}

    def remesh():
        remeshed["n"] += 1
        return step_fn

    calls = {"n": 0}

    def inject_once(step, retries):
        if step == 4 and calls["n"] < 4:
            calls["n"] += 1
            return True
        return False

    p, _, hist = run_training(
        cfg=RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=1,
                         max_retries=3),
        train_step=step_fn, params=params, opt_state=opt, batches=batches,
        num_steps=8, inject_failure=inject_once, remesh_fn=remesh)
    kinds = [h[0] for h in hist]
    assert "restart" in kinds and remeshed["n"] == 1
    assert float(p["w"][0]) == 8.0


def test_resume_from_existing_checkpoint(tmp_path):
    params, opt, step_fn, batches = _setup()
    run_training(cfg=RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=2),
                 train_step=step_fn, params=params, opt_state=opt,
                 batches=batches, num_steps=5)
    assert sorted(os.listdir(tmp_path)) == ["step_0", "step_2", "step_4"]
    p2, _, hist2 = run_training(
        cfg=RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=2),
        train_step=step_fn, params=params, opt_state=opt, batches=batches,
        num_steps=8)
    assert hist2[0][0] == "resume"
    assert float(p2["w"][0]) == 8.0
