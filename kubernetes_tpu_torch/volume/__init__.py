"""Volume plugin framework (ref: pkg/volume/).

- ``VolumePlugin``  — can_support(spec) + new_builder/new_cleaner
  (ref: pkg/volume/plugins.go:34-43)
- ``Builder.set_up()`` / ``Cleaner.tear_down()``
  (ref: pkg/volume/volume.go:33-55)
- ``VolumePluginMgr`` — plugin registry + find-by-spec
  (ref: plugins.go VolumePluginMgr.FindPluginBySpec)

Plugins: empty_dir, host_path, git_repo, secret, nfs, gce_pd
(ref: pkg/volume/{empty_dir,host_path,git_repo,secret,nfs,gce_pd}/).
Network/cloud plugins (nfs, gce_pd) take mounter/attacher seams so tests
run without privileges, exactly like the reference's mount.Interface fake.

Port of ``kubernetes_tpu/volume/__init__.py``.
"""

from kubernetes_tpu_torch.volume.plugins import (Builder, Cleaner,  # noqa: F401
                                           VolumePlugin, VolumePluginMgr,
                                           new_default_plugin_mgr)
