"""Volume plugins (ref: pkg/volume/).

Volume directories live under the kubelet root:
``<root>/pods/<pod-uid>/volumes/<escaped-plugin-name>/<volume-name>``
(ref: pkg/kubelet/kubelet.go GetPodVolumesDir + volume paths in each
plugin). ``set_up`` makes the directory exist with the right contents;
``tear_down`` removes it. Cloud/network mounts go through injectable
seams (``Mounter`` for nfs, ``DiskManager`` for gce_pd) so everything is
testable unprivileged — the reference does the same with mount.Interface.

Port of ``kubernetes_tpu/volume/plugins.py``.
"""

from __future__ import annotations

import base64
import binascii
import os
import shutil
import subprocess
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from kubernetes_tpu_torch.api import types as api

__all__ = ["Builder", "Cleaner", "VolumePlugin", "VolumePluginMgr",
           "Mounter", "FakeMounter", "ExecMounter", "DiskManager",
           "FakeDiskManager", "RefusingDiskManager",
           "new_default_plugin_mgr", "escape_plugin_name"]


def escape_plugin_name(name: str) -> str:
    """"kubernetes.io/empty-dir" -> "kubernetes.io~empty-dir"
    (ref: pkg/volume/plugins.go EscapePluginName)."""
    return name.replace("/", "~")


@dataclass
class VolumeHost:
    """What plugins need from the kubelet (ref: plugins.go VolumeHost)."""

    root_dir: str
    kubelet_client: Any = None       # for secret fetch

    def pod_volume_dir(self, pod_uid: str, plugin_name: str,
                       volume_name: str) -> str:
        return os.path.join(self.root_dir, "pods", pod_uid, "volumes",
                            escape_plugin_name(plugin_name), volume_name)

    def pod_volumes_dir(self, pod_uid: str) -> str:
        return os.path.join(self.root_dir, "pods", pod_uid, "volumes")


class Builder:
    """ref: volume.go Builder interface."""

    def set_up(self) -> None:
        raise NotImplementedError

    def get_path(self) -> str:
        raise NotImplementedError


class Cleaner:
    """ref: volume.go Cleaner interface."""

    def tear_down(self) -> None:
        raise NotImplementedError


class VolumePlugin:
    """ref: plugins.go VolumePlugin interface."""

    name = ""

    def init(self, host: VolumeHost) -> None:
        self.host = host

    def can_support(self, volume: api.Volume) -> bool:
        raise NotImplementedError

    def new_builder(self, volume: api.Volume, pod: api.Pod) -> Builder:
        raise NotImplementedError

    def new_cleaner(self, volume_name: str, pod_uid: str) -> Cleaner:
        raise NotImplementedError


class _DirBuilder(Builder, Cleaner):
    """Common directory-backed builder/cleaner."""

    def __init__(self, plugin: VolumePlugin, volume_name: str, pod_uid: str):
        self.plugin = plugin
        self.volume_name = volume_name
        self.pod_uid = pod_uid

    def get_path(self) -> str:
        return self.plugin.host.pod_volume_dir(
            self.pod_uid, self.plugin.name, self.volume_name)

    def tear_down(self) -> None:
        path = self.get_path()
        if os.path.lexists(path):
            if os.path.islink(path):
                os.unlink(path)
            else:
                shutil.rmtree(path, ignore_errors=True)


# ---------------------------------------------------------------------------
# empty_dir (ref: pkg/volume/empty_dir/)
# ---------------------------------------------------------------------------

class EmptyDirPlugin(VolumePlugin):
    name = "kubernetes.io/empty-dir"

    def can_support(self, volume: api.Volume) -> bool:
        return volume.source is not None and volume.source.empty_dir is not None

    def new_builder(self, volume: api.Volume, pod: api.Pod) -> Builder:
        b = _DirBuilder(self, volume.name, pod.metadata.uid)
        def set_up():
            os.makedirs(b.get_path(), exist_ok=True)
        b.set_up = set_up
        return b

    def new_cleaner(self, volume_name: str, pod_uid: str) -> Cleaner:
        return _DirBuilder(self, volume_name, pod_uid)


# ---------------------------------------------------------------------------
# host_path (ref: pkg/volume/host_path/ — just hands out the host path)
# ---------------------------------------------------------------------------

class HostPathPlugin(VolumePlugin):
    name = "kubernetes.io/host-path"

    def can_support(self, volume: api.Volume) -> bool:
        return volume.source is not None and volume.source.host_path is not None

    def new_builder(self, volume: api.Volume, pod: api.Pod) -> Builder:
        path = volume.source.host_path.path

        class _B(Builder):
            def set_up(self) -> None:  # nothing to do (ref: host_path.go SetUp)
                pass

            def get_path(self) -> str:
                return path
        return _B()

    def new_cleaner(self, volume_name: str, pod_uid: str) -> Cleaner:
        class _C(Cleaner):
            def tear_down(self) -> None:  # host dirs are never deleted
                pass
        return _C()


# ---------------------------------------------------------------------------
# git_repo (ref: pkg/volume/git_repo/ — clone into the volume dir)
# ---------------------------------------------------------------------------

class GitRepoPlugin(VolumePlugin):
    name = "kubernetes.io/git-repo"

    def __init__(self, exec_fn=None):
        # injectable for tests (ref: git_repo.go uses exec.Interface)
        self.exec_fn = exec_fn or self._real_exec

    @staticmethod
    def _real_exec(args: List[str], cwd: str) -> None:
        subprocess.run(args, cwd=cwd, check=True, capture_output=True)

    def can_support(self, volume: api.Volume) -> bool:
        return volume.source is not None and volume.source.git_repo is not None

    def new_builder(self, volume: api.Volume, pod: api.Pod) -> Builder:
        b = _DirBuilder(self, volume.name, pod.metadata.uid)
        src = volume.source.git_repo

        def set_up():
            path = b.get_path()
            if os.path.exists(path) and os.listdir(path):
                return  # idempotent resync
            os.makedirs(path, exist_ok=True)
            self.exec_fn(["git", "clone", src.repository, "."], path)
            if src.revision:
                self.exec_fn(["git", "checkout", src.revision], path)
        b.set_up = set_up
        return b

    def new_cleaner(self, volume_name: str, pod_uid: str) -> Cleaner:
        return _DirBuilder(self, volume_name, pod_uid)


# ---------------------------------------------------------------------------
# secret (ref: pkg/volume/secret/ — fetch Secret, write decoded files)
# ---------------------------------------------------------------------------

class SecretPlugin(VolumePlugin):
    name = "kubernetes.io/secret"

    def can_support(self, volume: api.Volume) -> bool:
        return volume.source is not None and volume.source.secret is not None

    def new_builder(self, volume: api.Volume, pod: api.Pod) -> Builder:
        b = _DirBuilder(self, volume.name, pod.metadata.uid)
        secret_name = volume.source.secret.secret_name
        namespace = pod.metadata.namespace
        client = self.host.kubelet_client

        def set_up():
            if client is None:
                raise RuntimeError(
                    "secret volumes need an API client on the kubelet")
            secret = client.secrets(namespace).get(secret_name)
            path = b.get_path()
            os.makedirs(path, exist_ok=True)
            for key, value in secret.data.items():
                # defense in depth vs. SecretStrategy.validate: a key that is
                # not a plain filename ('../x', 'a/b', '') could escape the
                # pod volume dir and overwrite arbitrary kubelet-host files
                if os.path.basename(key) != key or key in ("", ".", ".."):
                    raise ValueError(
                        f"secret {secret_name!r}: unsafe data key {key!r}")
                try:
                    raw = base64.b64decode(value, validate=True)
                except (binascii.Error, ValueError):
                    raw = value.encode()  # stored unencoded
                with open(os.path.join(path, key), "wb") as f:
                    f.write(raw)
        b.set_up = set_up
        return b

    def new_cleaner(self, volume_name: str, pod_uid: str) -> Cleaner:
        return _DirBuilder(self, volume_name, pod_uid)


# ---------------------------------------------------------------------------
# nfs (ref: pkg/volume/nfs/ — mount -t nfs server:path dir)
# ---------------------------------------------------------------------------

class Mounter:
    """ref: pkg/util/mount Interface (incl. the IsMountPoint check the
    reference's plugins use for SetUp idempotency)."""

    def mount(self, source: str, target: str, fstype: str,
              options: List[str]) -> None:
        raise NotImplementedError

    def unmount(self, target: str) -> None:
        raise NotImplementedError

    def is_mounted(self, target: str) -> bool:
        raise NotImplementedError

    def device_for(self, target: str) -> Optional[str]:
        """Source device mounted at ``target`` (for detach bookkeeping —
        ref: gce_pd.go TearDown reads the device back from the mount table)."""
        return None


class FakeMounter(Mounter):
    def __init__(self):
        self.mounts: Dict[str, tuple] = {}
        self.log: List[tuple] = []

    def mount(self, source, target, fstype, options):
        self.mounts[target] = (source, fstype, tuple(options))
        self.log.append(("mount", source, target, fstype))

    def unmount(self, target):
        self.mounts.pop(target, None)
        self.log.append(("unmount", target))

    def is_mounted(self, target):
        return target in self.mounts

    def device_for(self, target):
        entry = self.mounts.get(target)
        return entry[0] if entry else None


class ExecMounter(Mounter):
    def mount(self, source, target, fstype, options):
        cmd = ["mount", "-t", fstype]
        if options:
            cmd += ["-o", ",".join(options)]
        cmd += [source, target]
        subprocess.run(cmd, check=True, capture_output=True)

    def unmount(self, target):
        subprocess.run(["umount", target], check=True, capture_output=True)

    def is_mounted(self, target):
        real = os.path.realpath(target)
        try:
            with open("/proc/mounts") as f:
                return any(line.split()[1] == real for line in f)
        except OSError:
            return False

    def device_for(self, target):
        real = os.path.realpath(target)
        try:
            with open("/proc/mounts") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2 and parts[1] == real:
                        return parts[0]
        except OSError:
            pass
        return None


class NFSPlugin(VolumePlugin):
    name = "kubernetes.io/nfs"

    def __init__(self, mounter: Optional[Mounter] = None):
        self.mounter = mounter or FakeMounter()

    def can_support(self, volume: api.Volume) -> bool:
        return volume.source is not None and volume.source.nfs is not None

    def new_builder(self, volume: api.Volume, pod: api.Pod) -> Builder:
        b = _DirBuilder(self, volume.name, pod.metadata.uid)
        src = volume.source.nfs
        mounter = self.mounter

        def set_up():
            path = b.get_path()
            if mounter.is_mounted(path):
                return  # resync idempotency (ref: nfs.go SetUp IsMountPoint)
            os.makedirs(path, exist_ok=True)
            options = ["ro"] if src.read_only else []
            mounter.mount(f"{src.server}:{src.path}", path, "nfs", options)
        b.set_up = set_up
        return b

    def new_cleaner(self, volume_name: str, pod_uid: str) -> Cleaner:
        base = _DirBuilder(self, volume_name, pod_uid)
        mounter = self.mounter

        def tear_down():
            # gate on IsMountPoint as the reference does (nfs.go TearDown):
            # a dir left behind by a failed mount must not abort cleanup
            if mounter.is_mounted(base.get_path()):
                mounter.unmount(base.get_path())
            _DirBuilder.tear_down(base)
        base.tear_down = tear_down
        return base


# ---------------------------------------------------------------------------
# gce_pd (ref: pkg/volume/gce_pd/ — attach via cloud, mount by device)
# ---------------------------------------------------------------------------

class DiskManager:
    """ref: gce_pd.go diskManager (AttachDisk/DetachDisk seams)."""

    def attach_disk(self, pd_name: str, read_only: bool) -> str:
        """-> device path"""
        raise NotImplementedError

    def detach_disk(self, pd_name: str) -> None:
        raise NotImplementedError


class FakeDiskManager(DiskManager):
    def __init__(self):
        self.attached: Dict[str, bool] = {}
        self.log: List[tuple] = []

    def attach_disk(self, pd_name, read_only):
        self.attached[pd_name] = read_only
        self.log.append(("attach", pd_name, read_only))
        return f"/dev/disk/by-id/google-{pd_name}"

    def detach_disk(self, pd_name):
        self.attached.pop(pd_name, None)
        self.log.append(("detach", pd_name))


class RefusingDiskManager(DiskManager):
    """Installed when no real cloud disk backend exists: attaching fails
    loudly so the pod is rejected with a mount error instead of silently
    running against an empty local dir (advisor finding r1 #2)."""

    def attach_disk(self, pd_name, read_only):
        raise RuntimeError(
            f"cannot attach GCE PD {pd_name!r}: no disk manager configured "
            "on this kubelet (no cloud provider)")

    def detach_disk(self, pd_name):
        raise RuntimeError(
            f"cannot detach GCE PD {pd_name!r}: no disk manager configured "
            "on this kubelet (no cloud provider)")


def _device_to_pd_name(device: str) -> Optional[str]:
    """Map a mounted device back to its GCE pd name. The mount table holds
    the resolved node (/dev/sdb), not the /dev/disk/by-id/google-<pd> alias
    mount(8) was given — reverse it through the by-id symlinks."""
    name = os.path.basename(device)
    if name.startswith("google-"):
        return name[len("google-"):]
    by_id = "/dev/disk/by-id"
    try:
        real = os.path.realpath(device)
        for entry in os.listdir(by_id):
            if not entry.startswith("google-"):
                continue
            if os.path.realpath(os.path.join(by_id, entry)) == real:
                return entry[len("google-"):]
    except OSError:
        pass
    return None


class GCEPersistentDiskPlugin(VolumePlugin):
    name = "kubernetes.io/gce-pd"

    def __init__(self, disk_manager: Optional[DiskManager] = None,
                 mounter: Optional[Mounter] = None):
        self.disks = disk_manager or FakeDiskManager()
        self.mounter = mounter or FakeMounter()

    def can_support(self, volume: api.Volume) -> bool:
        return volume.source is not None and \
            volume.source.gce_persistent_disk is not None

    def new_builder(self, volume: api.Volume, pod: api.Pod) -> Builder:
        b = _DirBuilder(self, volume.name, pod.metadata.uid)
        src = volume.source.gce_persistent_disk
        disks, mounter = self.disks, self.mounter

        def set_up():
            path = b.get_path()
            if mounter.is_mounted(path):
                return  # resync idempotency (ref: gce_pd.go SetUp IsMountPoint)
            device = disks.attach_disk(src.pd_name, src.read_only)
            os.makedirs(path, exist_ok=True)
            options = ["ro"] if src.read_only else []
            mounter.mount(device, path, src.fs_type or "ext4", options)
        b.set_up = set_up
        b.pd_name = src.pd_name
        return b

    def new_cleaner(self, volume_name: str, pod_uid: str) -> Cleaner:
        base = _DirBuilder(self, volume_name, pod_uid)
        disks, mounter = self.disks, self.mounter

        def tear_down():
            # read the device back from the mount table to recover the pd
            # name, as the reference's TearDown does (gce_pd.go), so the
            # cloud attachment is released and not leaked
            device = mounter.device_for(base.get_path())
            if mounter.is_mounted(base.get_path()):
                mounter.unmount(base.get_path())
            if device:
                pd_name = _device_to_pd_name(device)
                if pd_name:
                    disks.detach_disk(pd_name)
            _DirBuilder.tear_down(base)
        base.tear_down = tear_down
        return base


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------

class VolumePluginMgr:
    """ref: plugins.go VolumePluginMgr.{InitPlugins,FindPluginBySpec}."""

    def __init__(self, plugins: List[VolumePlugin], host: VolumeHost):
        self.plugins = list(plugins)
        self.host = host
        for p in self.plugins:
            p.init(host)

    def find_plugin(self, volume: api.Volume) -> VolumePlugin:
        matches = [p for p in self.plugins if p.can_support(volume)]
        if not matches:
            raise ValueError(f"no volume plugin matched {volume.name!r}")
        if len(matches) > 1:
            raise ValueError(
                f"multiple volume plugins matched: "
                f"{', '.join(p.name for p in matches)}")
        return matches[0]

    def find_plugin_by_name(self, name: str) -> Optional[VolumePlugin]:
        for p in self.plugins:
            if p.name == name or escape_plugin_name(p.name) == name:
                return p
        return None

    # -- kubelet-facing helpers (ref: kubelet.go mountExternalVolumes
    #    :974-1005 and getPodVolumesFromDisk) -----------------------------
    def mount_volumes(self, pod: api.Pod) -> Dict[str, Builder]:
        out: Dict[str, Builder] = {}
        for volume in pod.spec.volumes:
            plugin = self.find_plugin(volume)
            builder = plugin.new_builder(volume, pod)
            builder.set_up()
            out[volume.name] = builder
        return out

    def volumes_on_disk(self, pod_uid: str) -> List[tuple]:
        """[(plugin, volume_name)] found under the pod's volumes dir."""
        root = self.host.pod_volumes_dir(pod_uid)
        found = []
        if not os.path.isdir(root):
            return found
        for plugin_dir in sorted(os.listdir(root)):
            plugin = self.find_plugin_by_name(plugin_dir)
            for name in sorted(os.listdir(os.path.join(root, plugin_dir))):
                found.append((plugin, name))
        return found

    def cleanup_orphaned_volumes(self, active_pod_uids: List[str]) -> int:
        """Tear down volumes of pods that no longer exist
        (ref: kubelet.go cleanupOrphanedVolumes:1523-1556)."""
        removed = 0
        pods_root = os.path.join(self.host.root_dir, "pods")
        if not os.path.isdir(pods_root):
            return 0
        active = set(active_pod_uids)
        for uid in sorted(os.listdir(pods_root)):
            if uid in active:
                continue
            vols = self.volumes_on_disk(uid)
            if any(plugin is None for plugin, _ in vols):
                # an unrecognized plugin dir may hold a live mount we can't
                # tear down — deleting through it would destroy its contents
                # (the reference likewise skips pods it cannot clean,
                # kubelet.go:1523-1556)
                continue
            for plugin, name in vols:
                plugin.new_cleaner(name, uid).tear_down()
                removed += 1
            shutil.rmtree(os.path.join(pods_root, uid), ignore_errors=True)
        return removed


def new_default_plugin_mgr(root_dir: str, kubelet_client=None,
                           mounter: Optional[Mounter] = None,
                           disk_manager: Optional[DiskManager] = None,
                           git_exec=None) -> VolumePluginMgr:
    """ref: cmd/kubelet ProbeVolumePlugins."""
    host = VolumeHost(root_dir=root_dir, kubelet_client=kubelet_client)
    return VolumePluginMgr([
        EmptyDirPlugin(),
        HostPathPlugin(),
        GitRepoPlugin(exec_fn=git_exec),
        SecretPlugin(),
        NFSPlugin(mounter=mounter),
        GCEPersistentDiskPlugin(disk_manager=disk_manager, mounter=mounter),
    ], host)
