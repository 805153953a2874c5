"""The port's scheme, validation, field selectors and REST mapper on the
v1 cases of tests/test_api_machinery.py. The two cases of the legacy
wire are left out: the port serves v1 alone until ``api/v1beta1.py`` and
``api/v1beta2.py`` are ported (ROADMAP Queue 1 item 13)."""

from test_torch_twin import port_twin

LEGACY = "the legacy v1beta1 wire is not ported (ROADMAP Queue 1 item 13)"

globals().update(port_twin("test_api_machinery", {
    "test_v1beta1_flattens_metadata": LEGACY,
    "test_convert_wire_between_versions": LEGACY,
}))
