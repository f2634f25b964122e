"""The seven identification documents of examples/json (the truss
time-domain, modal, FRF and field fits, and the plane, plate and frame
fits) through both packages' CLI `run()`, their refusals, and the FRF
route's gradient against a complex solve, on the CPU.

Each document's "n_iter" is cut to N_ITER for time (the corpus asks for
90 to 2500 ADAM iterations); the transient documents keep their n_steps.
Bounds (float32, both packages; each the largest difference over the
largest JAX value), measured at 10 iterations (the gaps grow with the
rows, so they bound the N_ITER = 5 the tests run):

  * truss scalar fits (time, modal, frequency): loss rows and identified
    values within SCALAR_RTOL (measured 5.1e-6, 1.2e-6, 2.0e-7);
  * the truss field fit: loss rows within FIELD_LOSS_RTOL (measured
    2.0e-4), the field at the elements within FIELD_RTOL (2.3e-5);
  * the plate zones: loss rows within PLATE_LOSS_RTOL (6.8e-5), moduli
    within PLATE_RTOL (9.8e-6);
  * the plane zones and the frame inertia: the JAX package scatters the
    plane's diagonals in float32 in XLA's order (the port in float64,
    rounded once), and the frame's float32 dense K spans EA / L ~ 4e9 to
    EI / L^3 ~ 2e7, so both float32 runs carry their own rounding:
    measured 1.0e-2 (plane loss rows), 1.0e-3 (plane moduli), 5.5e-4
    (frame loss rows), 5.5e-3 (frame inertia).  Those two documents are
    also run in float64 in both packages, where they agree within
    F64_RTOL, which shows that the float32 gaps are rounding.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
from pinn_fem_tpu.cli import generic as jax_cli  # noqa: E402
import torch  # noqa: E402

from pinn_fem_tpu_torch.cli import generic as torch_cli  # noqa: E402
from pinn_fem_tpu_torch.io.schema import parse_problem_dict  # noqa: E402
from pinn_fem_tpu_torch.solvers import frequency_inverse as t_frf  # noqa: E402
from pinn_fem_tpu_torch.utils.runtime import X64_VARIABLE  # noqa: E402

CORPUS = Path(__file__).resolve().parents[1] / "examples" / "json"
N_ITER = 5
SCALAR_RTOL = 1e-4
FIELD_LOSS_RTOL = 2e-3
FIELD_RTOL = 5e-4
PLATE_LOSS_RTOL = 1e-3
PLATE_RTOL = 1e-4
PLANE_LOSS_RTOL = 5e-2
PLANE_RTOL = 5e-3
FRAME_LOSS_RTOL = 5e-3
FRAME_RTOL = 5e-2
F64_RTOL = 1e-6

# document: (values key, values bound, loss-row bound)
DOCUMENTS = {
    "dyn-identification": ("identified", SCALAR_RTOL, SCALAR_RTOL),
    "dyn-identification-modal": ("identified", SCALAR_RTOL, SCALAR_RTOL),
    "dyn-identification-frf": ("identified", SCALAR_RTOL, SCALAR_RTOL),
    "dyn-identification-field": ("identified_field", FIELD_RTOL,
                                 FIELD_LOSS_RTOL),
    "dyn-plane-identify": ("young", PLANE_RTOL, PLANE_LOSS_RTOL),
    "dyn-plate-identify": ("young", PLATE_RTOL, PLATE_LOSS_RTOL),
    "dyn-frame-identify": ("inertia", FRAME_RTOL, FRAME_LOSS_RTOL),
}


def rel_err(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def cut(name: str, **analysis) -> dict:
    doc = json.loads((CORPUS / f"{name}.json").read_text())
    doc["analysis"].update({"n_iter": N_ITER, **analysis})
    return doc


def run_both(tmp_path, name: str, doc: dict):
    src = tmp_path / f"{name}.json"
    src.write_text(json.dumps(doc))
    j = jax_cli.run(str(src), str(tmp_path / "jax.res.json"))
    t = torch_cli.run(str(src), str(tmp_path / "port.res.json"),
                      device="cpu")
    return j, t


def values(out: dict, key: str) -> np.ndarray:
    v = out[key]
    if key == "identified":
        return np.asarray([v[k] for k in sorted(v)])
    if key == "identified_field":
        return np.asarray(v["at_elements"]["values"])
    return np.asarray(v)


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_document_matches_jax(tmp_path, name):
    """Each corpus identification document, n_iter cut to N_ITER, through
    both CLIs: the same result keys, loss rows and identified values
    within the document's bound (module docstring)."""
    key, v_rtol, h_rtol = DOCUMENTS[name]
    j, t = run_both(tmp_path, name, cut(name))
    assert sorted(j) == sorted(t)
    assert t["success"] is True and t["analysis"] == "identification"
    assert len(t["loss_history"]) == len(j["loss_history"])
    assert rel_err(j["loss_history"], t["loss_history"]) < h_rtol
    assert rel_err(values(j, key), values(t, key)) < v_rtol
    for k in ("zone_young", "measured_frequencies_hz", "probe_dofs",
              "sensor_dofs", "zones", "dt", "omegas"):
        if k in j:
            assert rel_err(np.asarray(j[k], float).ravel(),
                           np.asarray(t[k], float).ravel()) < v_rtol, k


@pytest.mark.parametrize("name", ["dyn-plane-identify",
                                  "dyn-frame-identify"])
def test_float32_gap_documents_agree_in_float64(tmp_path, monkeypatch,
                                                name):
    """The two documents with the widest float32 gaps agree in float64
    (five iterations; the plane wall cut to 8 x 40 elements)."""
    key = DOCUMENTS[name][0]
    doc = cut(name, n_iter=5)
    if "mesh" in doc:
        doc["mesh"].update(nx=8, ny=40)
    monkeypatch.setenv(X64_VARIABLE, "1")
    with jax.enable_x64(True):
        j, t = run_both(tmp_path, name, doc)
    assert rel_err(j["loss_history"], t["loss_history"]) < F64_RTOL
    assert rel_err(values(j, key), values(t, key)) < F64_RTOL


def test_on_device_key_is_read_and_changes_nothing(tmp_path):
    """"on_device": true (the JAX package's accelerator opt-in) runs the
    port on its device as without it, with the same result keys."""
    name = "dyn-identification-modal"
    src = tmp_path / "a.json"
    src.write_text(json.dumps(cut(name)))
    plain = torch_cli.run(str(src), str(tmp_path / "a.res.json"),
                          device="cpu")
    src.write_text(json.dumps(cut(name, on_device=True)))
    opted = torch_cli.run(str(src), str(tmp_path / "b.res.json"),
                          device="cpu")
    assert opted == plain


def broken(name: str, drop=(), **analysis) -> dict:
    """The document with analysis keys dropped and set; a generated mesh
    cut to 4 x 16 (the plane refusals raise after the twin-data solve)."""
    doc = cut(name, **analysis)
    for k in drop:
        doc["analysis"].pop(k)
    if name == "dyn-plane-identify":
        doc["mesh"].update(nx=4, ny=16)
    return doc


REFUSALS = {
    "ea_pair": broken("dyn-identification", params=["young", "area"],
                      n_steps=8),
    "auto_dt_measured": broken("dyn-identification", drop=("synthetic",),
                               dt="auto", measured=[[0.0, 0.0]] * 8,
                               n_steps=8),
    "both_measured_and_synthetic": broken(
        "dyn-identification", measured=[[0.0, 0.0]] * 8, n_steps=8),
    "unknown_domain": broken("dyn-identification", domain="laplace"),
    "modal_ratio": broken("dyn-identification-modal",
                          drop=("sensor_nodes",)),
    "frf_field": broken("dyn-identification-frf", field="young"),
    "field_and_params": broken("dyn-identification-field",
                               params=["young"]),
    "plane_zones_and_field": broken("dyn-plane-identify", field=True),
    "plane_overlapping_zones": broken(
        "dyn-plane-identify", zones=[{"y_max": 2.0}, {"y_max": 3.0}]),
    "plane_measured_and_synthetic": broken("dyn-plane-identify",
                                           measured_u=[0.0]),
    "plate_zone_young_without_zones": broken("dyn-plate-identify",
                                             drop=("zones",)),
    "plate_dense_with_zones": broken("dyn-plate-identify", banded=False),
    "frame_missing_measured_dofs": broken("dyn-frame-identify",
                                          drop=("measured_dofs",)),
    "frame_measured_and_synthetic": broken("dyn-frame-identify",
                                           measured_u=[0.0]),
    "frame_no_measurement": broken("dyn-frame-identify",
                                   drop=("synthetic",)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_equal_jax(tmp_path, case):
    """A refused block raises the JAX package's ValueError, word for word,
    before any ADAM iteration."""
    src = tmp_path / f"{case}.json"
    src.write_text(json.dumps(REFUSALS[case]))
    msgs = []
    for run, kw in ((jax_cli.run, {}), (torch_cli.run, {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            run(str(src), str(tmp_path / "out.json"), **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_real_block_gradient_equals_complex_solve():
    """The FRF route solves the real 2 x 2-block form, so no complex number
    enters autograd.  The same loss through a complex128 solve, where
    torch's conjugate-Wirtinger rule applies, gives the same real gradient
    of the real loss in the real parameters."""
    doc = json.loads((CORPUS / "dyn-identification-frf.json").read_text())
    problem = parse_problem_dict(doc).problem
    data = problem.to_device("cpu", torch.float64)
    om = np.linspace(0.05, 1.2, 40)
    probe = [2, 4]
    log_p = torch.tensor(np.log([2.0, 3.0, 0.08, 0.02]), dtype=torch.float64,
                         requires_grad=True)

    def operators(lp):
        from dataclasses import replace

        from pinn_fem_tpu_torch.models.fields import ScalarField
        from pinn_fem_tpu_torch.ops.assembly import assemble_system
        from pinn_fem_tpu_torch.ops.mass import lumped_mass

        mat = replace(problem.material,
                      young=ScalarField(value=torch.exp(lp[0])),
                      density=ScalarField(value=torch.exp(lp[1])))
        mask = data.free_mask
        k = assemble_system(data, mat, torch.zeros_like(data.loads))[0]
        return (mask[:, None] * k * mask[None, :],
                lumped_mass(data, mat) * mask, mask)

    k, m, mask = operators(log_p)
    amp = t_frf._frf_amplitudes(
        k, m, mask, data.loads * mask, torch.as_tensor(om), torch.exp(
            log_p[2]), torch.exp(log_p[3]), torch.as_tensor(probe))
    (g_real,) = torch.autograd.grad(torch.mean(torch.log(amp)), [log_p])

    log_c = log_p.detach().clone().requires_grad_()
    k, m, mask = operators(log_c)
    w = torch.as_tensor(om)[:, None, None]
    a = (k - w ** 2 * torch.diag(m) + torch.diag(1.0 - mask)).to(
        torch.complex128)
    c = (torch.exp(log_c[2]) * torch.diag(m) + torch.exp(log_c[3]) * k)
    z = a + 1j * (w * c).to(torch.complex128)
    f = (data.loads * mask).to(torch.complex128).expand(len(om), -1)
    x = torch.linalg.solve(z, f) * mask
    (g_cplx,) = torch.autograd.grad(
        torch.mean(torch.log(torch.abs(x[:, probe]))), [log_c])
    np.testing.assert_allclose(g_cplx.numpy(), g_real.numpy(), rtol=1e-9,
                               atol=1e-12)
