"""The port's label selectors, quantities and v1 codec on the cases of
tests/test_labels.py, tests/test_quantity.py and
tests/test_serialization.py. The round-trip fuzz runs over the versions
the port registers, v1 alone; the cases of the legacy v1beta1/v1beta2
wire are left out until it is ported (ROADMAP Queue 1 item 13)."""

from test_torch_twin import port_twin

LEGACY = "the legacy v1beta1/v1beta2 wire is not ported (Queue 1 item 13)"

globals().update(port_twin("test_labels"))
globals().update(port_twin("test_quantity"))
globals().update(port_twin("test_serialization", {
    "test_cross_version_conversion": LEGACY,
    "test_v1beta1_wire_shape_is_genuinely_divergent": LEGACY,
    "test_v1beta2_drops_the_deprecated_aliases": LEGACY,
    "test_v1beta1_defaulting_pass": LEGACY,
    "test_field_label_conversion": LEGACY,
    "test_endpoints_duplicate_addresses_keep_their_refs": LEGACY,
}))
