"""Object storage and fleet description: the JAX package's
``utils/object_store.py``, the same host code (reference
deeplearning4j-aws: aws/s3/ up/downloader, aws/ec2/Ec2BoxCreator).

- :class:`ObjectStore` is the transport-agnostic interface;
- :class:`LocalFileSystemObjectStore` implements it over a directory tree
  (bucket == subdirectory), which also serves hosts sharing a mount;
- :class:`S3ObjectStore` binds to boto3 when present and raises
  ``ImportError`` otherwise;
- :class:`FleetSpec` is a declarative worker-fleet description rendered
  to the command list a launcher needs.
"""

from __future__ import annotations

import shutil
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional


class ObjectStore:
    def upload(self, local_path, bucket: str, key: str) -> None:
        raise NotImplementedError

    def download(self, bucket: str, key: str, local_path) -> None:
        raise NotImplementedError

    def list_keys(self, bucket: str, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def delete(self, bucket: str, key: str) -> None:
        raise NotImplementedError


class LocalFileSystemObjectStore(ObjectStore):
    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, bucket: str, key: str) -> Path:
        p = (self.root / bucket / key).resolve()
        if self.root.resolve() not in p.parents:
            raise ValueError(f"key escapes store root: {key!r}")
        return p

    def upload(self, local_path, bucket: str, key: str) -> None:
        dst = self._path(bucket, key)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(local_path, dst)

    def download(self, bucket: str, key: str, local_path) -> None:
        Path(local_path).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(self._path(bucket, key), local_path)

    def list_keys(self, bucket: str, prefix: str = "") -> List[str]:
        bdir = self.root / bucket
        if not bdir.is_dir():
            return []
        keys = [str(p.relative_to(bdir)) for p in bdir.rglob("*")
                if p.is_file()]
        return sorted(k for k in keys if k.startswith(prefix))

    def delete(self, bucket: str, key: str) -> None:
        p = self._path(bucket, key)
        if p.exists():
            p.unlink()


class S3ObjectStore(ObjectStore):
    """boto3-backed store (gated: raises ImportError with guidance when the
    SDK is absent — reference aws/s3/uploader)."""

    def __init__(self, **client_kwargs):
        try:
            import boto3               # optional dep; not in this image
        except ImportError as e:
            raise ImportError(
                "S3ObjectStore requires boto3; use "
                "LocalFileSystemObjectStore (shared-mount staging) on TPU "
                "fleets without S3 access") from e
        self._s3 = boto3.client("s3", **client_kwargs)

    def upload(self, local_path, bucket: str, key: str) -> None:
        self._s3.upload_file(str(local_path), bucket, key)

    def download(self, bucket: str, key: str, local_path) -> None:
        self._s3.download_file(bucket, key, str(local_path))

    def list_keys(self, bucket: str, prefix: str = "") -> List[str]:
        out = self._s3.list_objects_v2(Bucket=bucket, Prefix=prefix)
        return [o["Key"] for o in out.get("Contents", [])]

    def delete(self, bucket: str, key: str) -> None:
        self._s3.delete_object(Bucket=bucket, Key=key)


@dataclass
class FleetSpec:
    """Declarative worker-fleet description (Ec2BoxCreator role): renders
    the launch commands for a TPU VM fleet rather than calling a cloud API."""

    num_workers: int = 1
    accelerator_type: str = "v5litepod-8"
    zone: str = "us-central2-b"
    runtime_version: str = "tpu-ubuntu2204-base"
    name_prefix: str = "dl4j-tpu-worker"
    startup_commands: List[str] = field(default_factory=list)

    def render_launch_commands(self) -> List[str]:
        cmds = []
        for i in range(self.num_workers):
            cmd = (f"gcloud compute tpus tpu-vm create "
                   f"{self.name_prefix}-{i} --zone={self.zone} "
                   f"--accelerator-type={self.accelerator_type} "
                   f"--version={self.runtime_version}")
            cmds.append(cmd)
        cmds += self.startup_commands
        return cmds
