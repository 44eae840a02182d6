"""Every matmul and convolution on the step path carries the package's
named precision (ops/precision.py), the same on every backend."""

import jax
import jax.extend
import jax.numpy as jnp
import pytest

from pysdr_tpu import app as app_mod
from pysdr_tpu.models.receiver import ReceiverBank
from pysdr_tpu.models.rtty import RTTYDesign, char_templates, matched_scores
from pysdr_tpu.ops import precision

BANK4 = ["--fs", "0.512", "--block", "1024", "--fc", "100.0", "100.05",
         "100.1", "100.15", "--modes", "AM", "NFM", "USB", "CW"]
CHAN = ["--channelize", "8", "--fs", "0.768", "--block", "1024",
        "--wire", "i8"]


def _bank4():
    args = app_mod.build_parser().parse_args(BANK4)
    bank = ReceiverBank(app_mod.build_config(args))
    x = jnp.zeros((bank.design.in_block, 2), jnp.float32)
    return bank._step_impl, (bank.state, x, bank.params)


def _chan():
    args = app_mod.build_parser().parse_args(CHAN)
    cb, _, _ = app_mod.build_channelizer(args)
    x = jnp.zeros((cb.in_block, 2), jnp.int8)
    return cb._step_impl, (cb.state, x, cb.params)


def _rtty():
    d = RTTYDesign(fs=48e3)
    t = jnp.asarray(char_templates(d))
    return matched_scores, (jnp.zeros((200, 3), jnp.float32), t)


STEPS = {"bank4": _bank4, "chan64": _chan, "rtty": _rtty}


def _products(jaxpr):
    """(primitive, precision) of every dot_general / conv in a jaxpr,
    sub-jaxprs (inner jits, scans, vmaps) included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            out.append((eqn.primitive.name, eqn.params["precision"]))
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _products(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _products(sub)
    return out


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_products_carry_the_named_precision(name):
    fn, args = STEPS[name]()
    prods = _products(jax.make_jaxpr(fn)(*args).jaxpr)
    assert prods, f"{name}: no matmul found"
    want = (jax.lax.Precision.HIGHEST,) * 2
    assert precision.matmul_precision() == jax.lax.Precision.HIGHEST
    for prim, prec in prods:
        assert prec == want, (name, prim, prec)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_has_no_backend_branch(name, monkeypatch):
    fn, args = STEPS[name]()
    ref = str(jax.make_jaxpr(fn)(*args))
    for backend in ("gpu", "tpu"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        assert str(jax.make_jaxpr(fn)(*args)) == ref, backend


def test_explicit_default_precision_keeps_its_meaning():
    fn, args = _bank4()
    with jax.default_matmul_precision("bfloat16"):
        prods = _products(jax.make_jaxpr(fn)(*args).jaxpr)
    want = (jax.lax.Precision.DEFAULT,) * 2
    assert prods and all(p == want for _, p in prods), prods

