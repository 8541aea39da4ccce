"""The config loader's YAML subset (core/config.parse_yaml)."""

import os

import pytest

from mundy_tpu.core.config import ConfigError, load_yaml, parse_yaml

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")

EXPECTED = [
    ("chromatin_1m_spectral.yaml", {"app": "chromatin", "params": {
        "num_chains": 2048, "beads_per_chain": 512, "bead_radius": 0.5,
        "num_crosslinkers": 65536, "binding_rate": 10.0,
        "unbinding_rate": 1.0, "diffusion_coeff": 0.05,
        "hydro": "rpy_spectral", "box_size": 152.0, "dt": 0.0001,
        "num_steps": 200, "log_every": 20, "dtype": "float32"}}),
    ("filaments_sperm.yaml", {"app": "filaments", "params": {
        "num_filaments": 128, "nodes_per_filament": 16,
        "segment_length": 1.0, "radius": 0.25, "bend_modulus": 5.0,
        "stretch_stiffness": 200.0, "active_amplitude": 0.5, "wave_k": 1.5,
        "wave_omega": 20.0, "drag_anisotropy": 2.0, "box_size": 60.0,
        "dt": 0.0002, "num_steps": 1000, "log_every": 100}}),
    ("granular_settling.yaml", {"app": "granular", "params": {
        "num_spheres": 5000, "box_size": 20.0, "radius": 0.5,
        "gravity": 10.0, "friction_coeff": 0.5, "dt": 0.0001,
        "num_steps": 5000, "log_every": 500}}),
    ("hp1_chromatin.yaml", {"app": "chromatin", "params": {
        "num_chains": 7, "beads_per_chain": 405, "bead_radius": 0.5,
        "num_crosslinkers": 512, "binding_rate": 10.0,
        "unbinding_rate": 1.0, "periphery_radius": 25.0,
        "diffusion_coeff": 0.1, "hydro": "rpy_periphery", "dt": 5e-06,
        "num_steps": 1000, "log_every": 100}}),
    ("lcp_spheres_100k.yaml", {"app": "lcp_spheres", "params": {
        "num_spheres": 100000, "box_size": 90.0, "radius": 0.5,
        "dt": 0.001, "num_steps": 100, "max_allowable_overlap": 1e-05,
        "max_col_iterations": 10000, "hydro": "none", "log_every": 10}}),
    ("rods_100k.yaml", {"app": "rods", "params": {
        "num_rods": 100000, "box_size": 140.0, "radius": 0.25,
        "length": 2.0, "diffusion_coeff": 0.05,
        "rot_diffusion_coeff": 0.05, "dt": 0.0001, "num_steps": 1000,
        "log_every": 100}}),
    ("spheres_10k.yaml", {"app": "spheres", "params": {
        "num_spheres": 10000, "box_size": 40.0, "radius": 0.5,
        "youngs_modulus": 1000.0, "diffusion_coeff": 0.1, "dt": 0.0001,
        "num_steps": 1000, "skin": 0.4, "log_every": 100}}),
]


def test_every_example_has_an_expectation():
    names = sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".yaml"))
    assert names == sorted(name for name, _ in EXPECTED)


@pytest.mark.parametrize("name,expected", EXPECTED,
                         ids=[name for name, _ in EXPECTED])
def test_example_parses_exactly(name, expected):
    got = load_yaml(os.path.join(EXAMPLES, name))
    assert got == expected
    # types, not just values: ints stay ints, floats stay floats
    for key, value in expected["params"].items():
        assert type(got["params"][key]) is type(value), key


def test_subset_features():
    text = (
        "# leading comment\n"
        "app: spheres   # trailing comment\n"
        "params:\n"
        "  box: [10, 12.5, 1.0e-3]\n"
        "  name: 'a # not a comment'\n"
        "  quoted: \"x: y\"\n"
        "  flags: [true, false, null]\n"
        "  empty: []\n"
        "  nested:\n"
        "    depth: 2\n"
        "  negative: -3\n"
        "  tilde: ~\n"
        "last:\n")
    assert parse_yaml(text) == {
        "app": "spheres",
        "params": {"box": [10, 12.5, 0.001], "name": "a # not a comment",
                   "quoted": "x: y", "flags": [True, False, None],
                   "empty": [], "nested": {"depth": 2}, "negative": -3,
                   "tilde": None},
        "last": None}
    assert parse_yaml("") == {}


@pytest.mark.parametrize("text,match", [
    ("- a\n", "block sequences"),
    ("a:\n  - 1\n", "block sequences"),
    ("a: &anchor 1\n", "unsupported"),
    ("a: *alias\n", "unsupported"),
    ("a: |\n  text\n", "unsupported"),
    ("a: {b: 1}\n", "unsupported"),
    ("a: [1, [2]]\n", "nested flow"),
    ("a: [1, 2\n", "unterminated"),
    ("a:\n\tb: 1\n", "tab"),
    ("a: 1\n  b: 2\n", "indentation"),
    ("a:\n    b: 1\n  c: 2\n", "indentation"),
    ("a: 1\na: 2\n", "duplicate"),
    ("---\na: 1\n", "document"),
    ("a:b\n", "key: value"),
    ("just text\n", "key: value"),
    ("a: 'open\n", "unsupported"),
])
def test_rejects_outside_subset(text, match):
    with pytest.raises(ConfigError, match=match):
        parse_yaml(text)
