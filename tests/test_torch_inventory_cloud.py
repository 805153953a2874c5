"""The port's inventory-file cloud provider (cloudprovider/inventory.py)
on the cases of tests/test_inventory_cloud.py: instances, addresses,
resources and zones, the reload on an mtime change, the refusal to
answer empty before a first load, the previous snapshot kept over a torn
or missing file, one snapshot per sync tick, and the registry's
``KTPU_CLOUD_INVENTORY``; and the port's kubectl doc generators
(``cmd/gendocs.py`` and ``cmd/genman.py``) covering every command."""

from test_torch_twin import port_twin

globals().update(port_twin("test_inventory_cloud"))
