"""Checkpoint packaging and hub upload (counterpart of
`evoworld_tpu/utils/artifacts.py`; upstream `utils/hf_utils.py`).

`package_checkpoint` writes the artifact an upload ships: a `MANIFEST.json`
(each file's path, size and the first 16 hex digits of its SHA-256) inside
the checkpoint directory, then a gzip tar of the directory, with the same
manifest and members as the JAX package's. `push_to_hub` uploads through
`huggingface_hub` where it is installed and credentialed, and raises
RuntimeError where it is not installed.
"""

from __future__ import annotations

import hashlib
import json
import os
import tarfile
from typing import Optional


def _sha256_16(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            digest.update(block)
    return digest.hexdigest()[:16]


def package_checkpoint(checkpoint_dir: str, out_path: str, note: str = "") -> str:
    """Tar a checkpoint directory with a manifest; returns the tar path."""
    manifest = {"note": note, "files": []}
    for root, _, files in os.walk(checkpoint_dir):
        for f in sorted(files):
            p = os.path.join(root, f)
            manifest["files"].append({
                "path": os.path.relpath(p, checkpoint_dir),
                "bytes": os.path.getsize(p),
                "sha256_16": _sha256_16(p),
            })
    with open(os.path.join(checkpoint_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    with tarfile.open(out_path, "w:gz") as tar:
        tar.add(checkpoint_dir, arcname=os.path.basename(checkpoint_dir.rstrip("/")))
    return out_path


def push_to_hub(checkpoint_dir: str, repo_id: str, token: Optional[str] = None) -> None:
    """Upload a checkpoint directory to the Hugging Face Hub."""
    try:
        from huggingface_hub import HfApi
    except ImportError as exc:
        raise RuntimeError(
            "huggingface_hub is not installed in this environment; use "
            "package_checkpoint() and upload the tarball from a networked host"
        ) from exc
    api = HfApi(token=token)
    api.create_repo(repo_id, exist_ok=True)
    api.upload_folder(folder_path=checkpoint_dir, repo_id=repo_id)
