"""Container registry credential providers (ref: pkg/credentialprovider/).

Port of ``kubernetes_tpu/credentialprovider/__init__.py``.

- ``DockerConfig``/``DockerConfigEntry`` — the ~/.dockercfg format
  (ref: config.go ReadDockerConfigFile)
- ``DockerKeyring`` — longest-match registry lookup
  (ref: keyring.go BasicDockerKeyring.Lookup)
- ``Provider`` seam + registry (ref: provider.go + plugins.go); the GCE
  metadata provider's slot is filled by ``EnvProvider`` (reads
  REGISTRY_AUTH_* env vars), since metadata servers aren't reachable here.
"""

from kubernetes_tpu_torch.credentialprovider.keyring import (  # noqa: F401
    DockerConfig, DockerConfigEntry, DockerKeyring, EnvProvider,
    FileProvider, Provider, default_keyring, register_provider)
