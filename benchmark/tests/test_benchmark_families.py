"""A configuration names its model family's reference module, its data's
shape and whether it is binarized; the harness reads the family through
the module's contract alone (``reference/__init__.py``).

* The MNIST configurations' inputs, shapes and work counts are those the
  harness gave when it read the MLP by name: the constants below were
  printed by that harness (the commit before the configurations named
  their family) at the same seed and sizes.
* A family enters as new files: a copy of ``vae.py`` under another name,
  named by a new configuration, gives the ``vae`` cells' numbers.
* Image data of any shape comes from the same recipe.
"""
from __future__ import annotations

import hashlib
import json
import math
import shutil

import pytest
import torch

import check
import generate
import reference
import run
from conftest import BENCH, digests, tiny_copy

SEED = 2**31 + 4321
SMALL = {"train_examples": 4096, "test_examples": 600}

# the harness's inputs and numbers before the configurations named their
# family: SHA-256 of each draw's bytes (CPU, float32 / int64), the
# reference's first three steps and a 3-sample IWAE pass at SMALL sizes,
# shapes() and the work counts at the configurations' own sizes
DATASET = "79482d75c54ecabcf090f7ba86cfdd11ff3be1b8c7c18ffad0b86ddd9caf49da"
EVAL_BINARY = ("6e50fa452839844abf844155ab2084a651d297f6005070b2330a705e9c"
               "99b812")
PARENT = {
    "h2s2e2-mnist": {
        "train": "train_b1024",
        "weights": "c5d729776fb1957771631eaaf16b7cbae7efd20bdb2e53133203c8ba"
                   "8963c8ce",
        "train_draws": [
            "59145af167b52c1c3ddec61f4d44847afc8103eb2e7e0d1e183d9dbcfaa8647b",
            "958490aa85d681be1c05e1ba788d2288ce50467822aa3447e2d61b9886257c70"],
        "iwae_noise": "7de35117811fdc5279f98097c2e714cae6f3bfad2189a67e0318"
                      "1496fe6e6631",
        "ref_losses": [877.9717257737175, 634.7628665137015,
                       585.8246198547547],
        "ref_grad_norms": 6122.397463388603,
        "ref_after_norms": 104.716317085066,
        "ref_iwae": [-403398.03711045155, -739.7943603430634,
                     -625.8319172583992],
        "shapes": {"D": 784, "H": 400, "W": 11, "Z": 8, "n_params": 636397,
                   "samples": 500, "eval_batch": 512, "decode_samples": 125},
        "train_step": {"gemm_macs": 1950105600, "executed_macs": 1628979200,
                       "bytes": 36486560},
        "iwae_example_flops": 317436000},
    "d2p2e2-mnist": {
        "train": "train_b256",
        "weights": "600934b4138bbb8293436df6419158b29969dbf1301e6c45bfdbd6a8"
                   "ffd90eab",
        "train_draws": [
            "a0d4b47c454e69225ea0914a061a71614eedccfb72d78b0b3e55ab80e7c43ce6",
            "e259248e43980e2ca3c6585d71d2aaacbfd76bdc7cc1f1ced5b8c372a1bd7c39"],
        "iwae_noise": "bf67d1b83854edc41b6d369b5d569b8fa8629837ce20d61592716"
                      "589b8a1d352",
        "ref_losses": [614.871684598806, 565.2030159582773,
                       539.3206992177036],
        "ref_grad_norms": 798.0305674006345,
        "ref_after_norms": 104.97978443876183,
        "ref_iwae": [-350097.959816186, -583.944060145633,
                     -589.6675970929103],
        "shapes": {"D": 784, "H": 400, "W": 12, "Z": 6, "n_params": 635998,
                   "samples": 500, "eval_batch": 512, "decode_samples": 125},
        "train_step": {"gemm_macs": 487219200, "executed_macs": 406937600,
                       "bytes": 24382400},
        "iwae_example_flops": 316636800},
}
# the float64 reference's numbers may move by its summation order only
REL = 1e-9


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def load(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("name", sorted(PARENT))
def test_inputs_shapes_and_work_are_the_parents(name):
    want = PARENT[name]
    cfg = load(BENCH / "configs" / f"{name}.json")
    assert "data_dim" not in cfg
    ref = reference.load(BENCH / "reference", cfg["reference"])
    small = {**cfg, **SMALL}
    tr = load(BENCH / "traffic" / f"{want['train']}.json")
    iw = load(BENCH / "traffic" / "iwae500.json")

    train, test = generate.dataset(small, SEED, "cpu")
    assert train.shape == (4096, 784) and test.shape == (600, 784)
    assert digest(train, test) == DATASET
    w = generate.weights(ref, small, SEED, "cpu")
    assert digest(*w.values()) == want["weights"]
    for epoch in (0, 1):
        draws = generate.train_draws(ref, small, tr, SEED, epoch, "cpu")
        assert digest(*draws) == want["train_draws"][epoch]
    assert digest(generate.iwae_noise(ref, small, iw, SEED, 0, "cpu")) == \
        want["iwae_noise"]
    batches, rows = check.eval_rows(small, test)
    assert digest(*[check.eval_batch(small, SEED, rows[i], batches[i])
                    for i in range(len(batches))]) == EVAL_BINARY

    losses, grad, after = check.reference_train(ref, small, tr, SEED, train,
                                                w)
    assert losses.tolist() == pytest.approx(want["ref_losses"], rel=REL)
    assert sum(float(v.norm()) for v in grad.values()) == pytest.approx(
        want["ref_grad_norms"], rel=REL)
    assert sum(float(v.norm()) for v in after.values()) == pytest.approx(
        want["ref_after_norms"], rel=REL)
    est = check.reference_iwae(ref, small, {**iw, "samples": 3}, SEED, test,
                               w, 1)
    assert [float(est.sum()), float(est[0]), float(est[-1])] == \
        pytest.approx(want["ref_iwae"], rel=REL)

    lats = ref.parse_spec(cfg["spec"])
    for traffic, batch in ((tr, tr["batch_size"]), (iw, None)):
        assert run.shapes(cfg, traffic, ref) == {**want["shapes"],
                                                 "batch": batch}
        counts = ref.work(cfg, lats, traffic)
        assert counts["train_step"] == (want["train_step"] if batch
                                        else None)
    assert ref.work(cfg, lats, iw)["iwae_example_flops"] == \
        want["iwae_example_flops"]


def test_no_harness_module_names_a_family():
    for path in BENCH.glob("*.py"):
        text = path.read_text()
        assert "from reference import vae" not in text, path
        assert "import reference.vae" not in text, path


def _add_cell(root, bench, cell, config, traffic, source):
    """A new cell ``cell`` of ``config`` and ``traffic`` as a new workload
    file, a copy of ``source``'s, and new BENCHMARK.json entries (its name
    appended to the lists of the metrics ``source`` reports)."""
    wl = load(root / "benchmark/workloads" / f"{source}.json")
    (root / "benchmark/workloads" / f"{cell}.json").write_text(json.dumps(
        {**wl, "config": config, "traffic": traffic}))
    entry = next(w for w in bench["workloads"] if w["name"] == source)
    bench["workloads"].append({**entry, "name": cell, "config": config,
                               "traffic": traffic})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if source in m.get("workloads", ()):
            m["workloads"].append(cell)


@pytest.fixture(scope="module")
def family_copy(tmp_path_factory):
    """A tiny copy of the benchmark, then as new files: ``vae_again.py``
    (``vae.py`` under another name), the flagship's tiny configuration
    naming it and its training and IWAE cells, and a CIFAR-shaped
    configuration (``[32, 32, 3]``, not binarized) with a training cell."""
    root = tmp_path_factory.mktemp("family")
    names = tiny_copy(root)
    before = digests(root)
    ref_dir = root / "benchmark/reference"
    shutil.copy(ref_dir / "vae.py", ref_dir / "vae_again.py")
    bench = load(root / "BENCHMARK.json")
    cfg = load(root / "benchmark/configs/h2s2e2-mnist.tiny.json")
    new = {}
    for config, extra in (("h2s2e2-again", {"reference": "vae_again"}),
                          ("h2s2e2-cifar", {"data_shape": [32, 32, 3],
                                            "binarize": False,
                                            "arch": "conv"})):
        (root / "benchmark/configs" / f"{config}.json").write_text(
            json.dumps({**cfg, **extra, "name": config}))
        bench["configs"].append({
            "name": config, "source": "test", "reduced": [], "why": "test",
            "file": f"benchmark/configs/{config}.json"})
    for cell, config in (("h2s2e2.train_b1024", "h2s2e2-again"),
                         ("h2s2e2.iwae500", "h2s2e2-again"),
                         ("h2s2e2.train_b1024", "h2s2e2-cifar")):
        tiny = names[cell]
        traffic = next(w["traffic"] for w in bench["workloads"]
                       if w["name"] == tiny)
        new[(cell, config)] = f"{tiny}.{config}"
        _add_cell(root, bench, new[(cell, config)], config, traffic, tiny)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    after = digests(root)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {p for p in before if p.name == "BENCHMARK.json"}
    return root, names, new


@pytest.mark.parametrize("cell", ["h2s2e2.train_b1024", "h2s2e2.iwae500"])
def test_a_family_enters_as_new_files(family_copy, cell):
    """The cell of a configuration whose ``reference`` names a module found
    only in the copy runs, and its numbers are the ``vae`` cell's (traced
    runs: a fixed number of units, so the same IWAE passes are checked)."""
    import programs
    root, names, new = family_copy
    found = run.find_cell(root, new[(cell, "h2s2e2-again")])
    assert found["ref"].__file__.endswith("vae_again.py")
    results = [run.run_cell(c, 11, 0.1, True, "cpu", root=root,
                            programs=programs)
               for c in (names[cell], new[(cell, "h2s2e2-again")])]
    assert all(r["correct"] for r in results), [r["checks"] for r in results]
    assert results[0]["checks"] == results[1]["checks"]
    assert results[0]["look"]["numbers"] == results[1]["look"]["numbers"]


def test_image_data_of_any_shape(family_copy):
    """``[32, 32, 3]``: (N, 32, 32, 3) intensities in [0, 1], channels
    last, from the same recipe; no binarization uniforms where the
    configuration does not binarize; the program builds the conv model on
    them and its training epoch runs on the harness's draws."""
    import programs
    root, _, new = family_copy
    cell = run.find_cell(root, new[("h2s2e2.train_b1024", "h2s2e2-cifar")])
    cfg, traffic, ref = cell["config"], cell["traffic"], cell["ref"]
    train, test = generate.dataset(cfg, SEED, "cpu")
    assert train.shape == (cfg["train_examples"], 32, 32, 3)
    assert test.shape == (cfg["test_examples"], 32, 32, 3)
    for x in (train, test):
        assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
        # every example reaches 1 somewhere, the channels differ
        assert torch.allclose(x.amax(dim=(1, 2, 3)), torch.ones(len(x)))
        assert not torch.equal(x[..., 0], x[..., 1])
    perm, u, noise = generate.train_draws(ref, cfg, traffic, SEED, 0, "cpu")
    assert u is None
    trainer = programs.build(cfg, traffic, SEED, train, test, "cpu", "unused")
    assert trainer.model_cfg.data_shape == (32, 32, 3)
    assert trainer.model_cfg.arch == "conv"
    assert trainer.dataset.binarize is False
    prog = programs.Train(trainer)
    means = prog.means(prog.run(perm, u, noise))
    assert all(math.isfinite(v) for v in means.values()
               if isinstance(v, float))


def test_a_family_may_draw_its_own_noise():
    """A reference module's ``noise`` draws a cell's training and IWAE
    noise in place of the N(0, 1) recipe, from the draw's own generator."""
    cfg = {**load(BENCH / "configs/h2s2e2-mnist.json"),
           "train_examples": 8, "test_examples": 4, "eval_batch_size": 4}
    vae = reference.load(BENCH / "reference", "vae")
    seen = []

    class Family:
        parse_spec = staticmethod(vae.parse_spec)

        @staticmethod
        def noise(lats, shape, gen, device):
            seen.append(shape)
            E = sum(l.noise_width for l in lats)
            return torch.rand(shape + (E,), generator=gen, device=device)

    _, _, nz = generate.train_draws(Family, cfg, {"batch_size": 4}, 1, 0,
                                    "cpu")
    iw = generate.iwae_noise(Family, cfg, {"samples": 3}, 1, 0, "cpu")
    assert seen == [(2, 4), (1, 3, 4)]
    assert nz.shape == (2, 4, 7) and iw.shape == (1, 3, 4, 7)
    assert float(nz.min()) >= 0.0 and float(iw.max()) < 1.0
    again = generate.iwae_noise(Family, cfg, {"samples": 3}, 1, 0, "cpu")
    assert torch.equal(iw, again)


def test_a_one_channel_image_is_todays_flat_draw():
    """``[28, 28, 1]`` and ``[784]`` draw the same intensities."""
    gen_a = generate.generator("cpu", SEED, "data")
    gen_b = generate.generator("cpu", SEED, "data")
    a = generate.intensities(50, [784], gen_a, "cpu")
    b = generate.intensities(50, [28, 28, 1], gen_b, "cpu")
    assert torch.equal(a, b.reshape(50, 784))
    with pytest.raises(ValueError):
        generate.intensities(2, [3072], gen_a, "cpu")
