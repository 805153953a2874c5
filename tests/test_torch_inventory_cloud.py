"""The port's inventory-file cloud provider (cloudprovider/inventory.py)
on the cases of tests/test_inventory_cloud.py: instances, addresses,
resources and zones, the reload on an mtime change, the refusal to
answer empty before a first load, the previous snapshot kept over a torn
or missing file, one snapshot per sync tick, and the registry's
``KTPU_CLOUD_INVENTORY``.

Left out: ``test_gendocs_and_genman_cover_every_command``, which tests
the reference's kubectl doc generators (``cmd/gendocs.py`` and
``cmd/genman.py`` build on ``kubectl/``, which the port does not have
yet); the module's import of them is dropped with it."""

from test_torch_twin import port_twin

KUBECTL = "tests cmd/gendocs.py and cmd/genman.py, which need kubectl/"

globals().update(port_twin(
    "test_inventory_cloud",
    {"test_gendocs_and_genman_cover_every_command": KUBECTL},
    rename={"from kubernetes_tpu_torch.cmd import gendocs, genman\n": ""}))
