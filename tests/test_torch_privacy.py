"""The port's RDP accountant (``core/privacy.py``) against the JAX
package's: host numpy in both, so every ε, every RDP curve and every
refusal is bit-equal (``==`` on floats, ``array_equal`` on curves)."""

import math

import numpy as np
import pytest

from fedml_tpu.core import privacy as jpriv
from fedml_tpu_torch.core import privacy as tpriv

CASES = [(q, z) for q in (0.0, 0.003, 0.05, 0.3, 1.0)
         for z in (0.0, 0.5, 1.0, 2.7)]


@pytest.mark.parametrize("q,z", CASES)
def test_rdp_curves_bit_equal(q, z):
    orders = tpriv.DEFAULT_ORDERS
    assert orders == jpriv.DEFAULT_ORDERS
    assert np.array_equal(tpriv.rdp_subsampled_gaussian(q, z, orders),
                          jpriv.rdp_subsampled_gaussian(q, z, orders))
    assert np.array_equal(tpriv.rdp_fixed_size_wor(q, z, orders),
                          jpriv.rdp_fixed_size_wor(q, z, orders))


@pytest.mark.parametrize("sampling", ["poisson", "fixed_size_wor"])
@pytest.mark.parametrize("q,z,delta,steps", [
    (0.01, 1.1, 1e-5, 1), (0.01, 1.1, 1e-5, 300), (0.2, 0.8, 1e-6, 50),
    (1.0, 1.0, 1e-5, 3), (10 / 3400, 1.0, 1e-5, 3)])
def test_epsilon_bit_equal(sampling, q, z, delta, steps):
    a = tpriv.RdpAccountant(q, z, delta, sampling=sampling)
    b = jpriv.RdpAccountant(q, z, delta, sampling=sampling)
    a.step(steps)
    b.step(steps)
    assert a.epsilon() == b.epsilon()
    assert math.isfinite(a.epsilon()) and a.epsilon() > 0


def test_edges_and_refusals_match():
    a = tpriv.RdpAccountant(0.1, 0.0, 1e-5)
    a.step()
    assert a.epsilon() == math.inf
    assert tpriv.RdpAccountant(0.1, 1.0, 1e-5).epsilon() == 0.0
    for fn in (lambda m: m.rdp_subsampled_gaussian(1.5, 1.0, (2,)),
               lambda m: m.rdp_subsampled_gaussian(0.5, 1.0, (1,)),
               lambda m: m.eps_from_rdp(np.ones(3), (2, 4, 8), 2.0)):
        with pytest.raises(ValueError) as t_err:
            fn(tpriv)
        with pytest.raises(ValueError) as j_err:
            fn(jpriv)
        assert str(t_err.value) == str(j_err.value)
