"""The port's share segment (apiserver/share.py) and its users on every
case of tests/test_share.py: the segment's checks, the shared fairshed
ledger across attachments, the governor and Retry-After hints agreeing
across workers, frame records imported bit-identical, ring wrap and lap,
and one apiserver importing a sibling's seeded encoding."""

from test_torch_twin import port_twin

globals().update(port_twin("test_share"))
