"""vmbackup / vmrestore (reference app/vmbackup, app/vmrestore,
lib/backup/actions/{backup,restore}.go): incremental part-level sync of an
instant snapshot to a destination, and restore with unchanged-part skip.

Destinations: fs://<path> (the reference additionally ships s3/gcs/azure
drivers behind the same interface; RemoteFS here is that interface and
fs:// its first driver).

Run: python -m victoriametrics_tpu_torch.apps.vmbackup
-storageDataPath=DIR -snapshot.createURL=http://HOST:8428 -dst=fs://BACKUP
(or -snapshotName=NAME); restore through ``main_restore([-src=fs://BACKUP,
-storageDataPath=NEW])``.

The port's copy of ``victoriametrics_tpu/apps/vmbackup.py``, whole; S3
requests are signed by the port's ``ingest/discovery._sigv4_headers``."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import urllib.error
import urllib.request

from ..utils import logger


class RemoteFS:
    """Destination interface (lib/backup/common/fs.go analog)."""

    def list_files(self) -> dict[str, int]:
        raise NotImplementedError

    def upload(self, rel: str, src_path: str):
        raise NotImplementedError

    def download(self, rel: str, dst_path: str):
        raise NotImplementedError

    def delete(self, rel: str):
        raise NotImplementedError


class FsRemote(RemoteFS):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def list_files(self) -> dict[str, int]:
        out = {}
        for dp, _, fns in os.walk(self.root):
            for fn in fns:
                full = os.path.join(dp, fn)
                out[os.path.relpath(full, self.root)] = os.path.getsize(full)
        return out

    def upload(self, rel: str, src_path: str):
        dst = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy2(src_path, dst)

    def download(self, rel: str, dst_path: str):
        os.makedirs(os.path.dirname(dst_path), exist_ok=True)
        shutil.copy2(os.path.join(self.root, rel), dst_path)

    def delete(self, rel: str):
        try:
            os.unlink(os.path.join(self.root, rel))
        except FileNotFoundError:
            pass


class S3Remote(RemoteFS):
    """s3://bucket/prefix destination (lib/backup/s3remote/s3.go analog):
    plain S3 REST calls signed with SigV4. `endpoint` override (the
    -customS3Endpoint flag) points it at MinIO / fake servers."""

    def __init__(self, bucket: str, prefix: str, region: str = "us-east-1",
                 endpoint: str = "", access_key: str = "",
                 secret_key: str = ""):
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.region = region
        self.endpoint = (endpoint.rstrip("/") if endpoint else
                         f"https://s3.{region}.amazonaws.com")
        self.access_key = access_key or os.environ.get(
            "AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", "")

    def _url(self, rel: str = "", query: str = "") -> str:
        key = "/".join(x for x in (self.bucket, self.prefix, rel) if x)
        u = f"{self.endpoint}/{key}"
        return u + ("?" + query if query else "")

    def _call(self, method: str, url: str, body: bytes = b"") -> bytes:
        from ..ingest.discovery import _sigv4_headers
        headers = {}
        if self.access_key and self.secret_key:
            headers = _sigv4_headers(method, url, body, self.region,
                                     "s3", self.access_key,
                                     self.secret_key)
        req = urllib.request.Request(url, data=body or None,
                                     headers=headers, method=method)
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    def list_files(self) -> dict[str, int]:
        import urllib.parse
        import xml.etree.ElementTree as ET
        out: dict[str, int] = {}
        prefix = "/".join(x for x in (self.prefix,) if x)
        token = ""
        while True:
            q = "list-type=2&prefix=" + urllib.parse.quote(
                prefix + "/" if prefix else "")
            if token:
                q += "&continuation-token=" + urllib.parse.quote(token)
            data = self._call("GET", f"{self.endpoint}/{self.bucket}?{q}")
            root = ET.fromstring(data)
            ns = root.tag[:root.tag.index("}") + 1] if                 root.tag.startswith("{") else ""
            for c in root.iter(f"{ns}Contents"):
                key = c.find(f"{ns}Key").text
                size = int(c.find(f"{ns}Size").text)
                rel = key[len(prefix) + 1:] if prefix else key
                out[rel] = size
            trunc = root.find(f"{ns}IsTruncated")
            if trunc is None or trunc.text != "true":
                break
            token = root.find(f"{ns}NextContinuationToken").text
        return out

    def upload(self, rel: str, src_path: str):
        with open(src_path, "rb") as f:
            self._call("PUT", self._url(rel), f.read())

    def download(self, rel: str, dst_path: str):
        os.makedirs(os.path.dirname(dst_path), exist_ok=True)
        data = self._call("GET", self._url(rel))
        with open(dst_path, "wb") as f:
            f.write(data)

    def delete(self, rel: str):
        try:
            self._call("DELETE", self._url(rel))
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise


class GcsRemote(RemoteFS):
    """gs://bucket/prefix destination (lib/backup/gcsremote/gcs.go analog)
    over the GCS JSON/XML-free REST API. Auth: explicit bearer token
    (GCS_ACCESS_TOKEN / token kwarg) or the GCE metadata server — the
    standard on-GCP path; `endpoint` points it at fake-gcs-server-style
    local fakes."""

    def __init__(self, bucket: str, prefix: str, endpoint: str = "",
                 token: str = ""):
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.endpoint = (endpoint.rstrip("/") if endpoint
                         else "https://storage.googleapis.com")
        self._token = token or os.environ.get("GCS_ACCESS_TOKEN", "")
        self._meta_token_exp = 0.0

    def _auth(self) -> dict:
        if not self._token or self._meta_token_exp:
            import time as _t
            now = _t.time()
            if self._meta_token_exp and now < self._meta_token_exp - 60:
                return ({"Authorization": f"Bearer {self._token}"}
                        if self._token else {})
            try:
                req = urllib.request.Request(
                    "http://metadata.google.internal/computeMetadata/v1/"
                    "instance/service-accounts/default/token",
                    headers={"Metadata-Flavor": "Google"})
                with urllib.request.urlopen(req, timeout=5) as r:
                    tok = json.loads(r.read())
                self._token = tok["access_token"]
                self._meta_token_exp = now + tok.get("expires_in", 300)
            except Exception:
                # anonymous (public buckets / auth-free fakes): remember the
                # verdict so every object op doesn't re-stall 5s on a doomed
                # metadata fetch
                self._meta_token_exp = now + 300
        return {"Authorization": f"Bearer {self._token}"} if self._token \
            else {}

    def _key(self, rel: str) -> str:
        return "/".join(x for x in (self.prefix, rel) if x)

    def _call(self, method: str, url: str, body: bytes | None = None,
              headers: dict | None = None) -> bytes:
        h = dict(headers or {})
        h.update(self._auth())
        req = urllib.request.Request(url, data=body, headers=h,
                                     method=method)
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    def list_files(self) -> dict[str, int]:
        import urllib.parse
        out: dict[str, int] = {}
        prefix = self._key("")
        token = ""
        while True:
            q = "prefix=" + urllib.parse.quote(
                prefix + "/" if prefix else "", safe="")
            if token:
                q += "&pageToken=" + urllib.parse.quote(token)
            data = self._call(
                "GET", f"{self.endpoint}/storage/v1/b/{self.bucket}/o?{q}")
            resp = json.loads(data)
            for item in resp.get("items", []):
                name = item["name"]
                rel = name[len(prefix) + 1:] if prefix else name
                out[rel] = int(item["size"])
            token = resp.get("nextPageToken", "")
            if not token:
                break
        return out

    def upload(self, rel: str, src_path: str):
        import urllib.parse
        with open(src_path, "rb") as f:
            body = f.read()
        self._call(
            "POST",
            f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o"
            f"?uploadType=media&name=" +
            urllib.parse.quote(self._key(rel), safe=""),
            body, {"Content-Type": "application/octet-stream"})

    def download(self, rel: str, dst_path: str):
        import urllib.parse
        os.makedirs(os.path.dirname(dst_path), exist_ok=True)
        data = self._call(
            "GET", f"{self.endpoint}/storage/v1/b/{self.bucket}/o/" +
            urllib.parse.quote(self._key(rel), safe="") + "?alt=media")
        with open(dst_path, "wb") as f:
            f.write(data)

    def delete(self, rel: str):
        import urllib.parse
        try:
            self._call(
                "DELETE", f"{self.endpoint}/storage/v1/b/{self.bucket}/o/" +
                urllib.parse.quote(self._key(rel), safe=""))
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise


class AzblobRemote(RemoteFS):
    """azblob://container/prefix destination (lib/backup/azremote/azblob.go
    analog). Auth: SAS token (AZURE_STORAGE_SAS_TOKEN) or SharedKey request
    signing with AZURE_STORAGE_ACCOUNT_{NAME,KEY} — pure hmac/hashlib, no
    SDK. `endpoint` override (AZURE_STORAGE_DOMAIN analog) points it at
    Azurite-style local fakes."""

    API_VERSION = "2021-06-08"

    def __init__(self, container: str, prefix: str, account: str = "",
                 key: str = "", sas: str = "", endpoint: str = ""):
        self.container = container
        self.prefix = prefix.strip("/")
        self.account = account or os.environ.get(
            "AZURE_STORAGE_ACCOUNT_NAME", "")
        self.key = key or os.environ.get("AZURE_STORAGE_ACCOUNT_KEY", "")
        self.sas = (sas or os.environ.get(
            "AZURE_STORAGE_SAS_TOKEN", "")).lstrip("?")
        self.endpoint = (endpoint.rstrip("/") if endpoint else
                         f"https://{self.account}.blob.core.windows.net")

    def _key_of(self, rel: str) -> str:
        return "/".join(x for x in (self.prefix, rel) if x)

    def _signed_headers(self, method: str, url: str, body_len: int,
                        headers: dict) -> dict:
        """SharedKey authorization (the x-ms-date + canonicalized string
        HMAC-SHA256 scheme)."""
        import base64
        import hashlib
        import hmac
        import urllib.parse
        from email.utils import formatdate
        h = dict(headers)
        h["x-ms-date"] = formatdate(usegmt=True)
        h["x-ms-version"] = self.API_VERSION
        if not self.key:
            return h
        parsed = urllib.parse.urlsplit(url)
        canon_headers = "".join(
            f"{k.lower()}:{v}\n" for k, v in
            sorted((k, v) for k, v in h.items()
                   if k.lower().startswith("x-ms-")))
        canon_res = f"/{self.account}{parsed.path}"
        if parsed.query:
            params = urllib.parse.parse_qs(parsed.query,
                                           keep_blank_values=True)
            for k in sorted(params):
                canon_res += f"\n{k.lower()}:{','.join(params[k])}"
        cl = str(body_len) if body_len else ""
        to_sign = (f"{method}\n\n\n{cl}\n\n"
                   f"{h.get('Content-Type', '')}\n\n\n\n\n\n\n"
                   f"{canon_headers}{canon_res}")
        sig = base64.b64encode(hmac.new(
            base64.b64decode(self.key), to_sign.encode("utf-8"),
            hashlib.sha256).digest()).decode()
        h["Authorization"] = f"SharedKey {self.account}:{sig}"
        return h

    def _call(self, method: str, path: str, query: str = "",
              body: bytes | None = None,
              headers: dict | None = None) -> bytes:
        import urllib.parse
        q = query
        if self.sas:
            q = (q + "&" if q else "") + self.sas
        url = f"{self.endpoint}{path}" + (f"?{q}" if q else "")
        h = self._signed_headers(method, url, len(body) if body else 0,
                                 headers or {})
        req = urllib.request.Request(url, data=body, headers=h,
                                     method=method)
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.read()

    def list_files(self) -> dict[str, int]:
        import urllib.parse
        import xml.etree.ElementTree as ET
        out: dict[str, int] = {}
        prefix = self._key_of("")
        marker = ""
        while True:
            q = "restype=container&comp=list&prefix=" + urllib.parse.quote(
                prefix + "/" if prefix else "", safe="")
            if marker:
                q += "&marker=" + urllib.parse.quote(marker)
            data = self._call("GET", f"/{self.container}", q)
            root = ET.fromstring(data)
            for b in root.iter("Blob"):
                name = b.find("Name").text
                size = int(b.find("Properties/Content-Length").text)
                rel = name[len(prefix) + 1:] if prefix else name
                out[rel] = size
            nm = root.find("NextMarker")
            marker = (nm.text or "") if nm is not None else ""
            if not marker:
                break
        return out

    def _blob_path(self, rel: str) -> str:
        import urllib.parse
        return f"/{self.container}/" + urllib.parse.quote(
            self._key_of(rel), safe="/")

    def upload(self, rel: str, src_path: str):
        with open(src_path, "rb") as f:
            body = f.read()
        self._call("PUT", self._blob_path(rel), "", body,
                   {"x-ms-blob-type": "BlockBlob",
                    "Content-Type": "application/octet-stream"})

    def download(self, rel: str, dst_path: str):
        os.makedirs(os.path.dirname(dst_path), exist_ok=True)
        data = self._call("GET", self._blob_path(rel))
        with open(dst_path, "wb") as f:
            f.write(data)

    def delete(self, rel: str):
        try:
            self._call("DELETE", self._blob_path(rel))
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise


def open_remote(dst: str, **kw) -> RemoteFS:
    if dst.startswith("fs://"):
        return FsRemote(dst[5:])
    if dst.startswith("s3://"):
        rest = dst[5:]
        bucket, _, prefix = rest.partition("/")
        return S3Remote(bucket, prefix, **kw)
    for scheme in ("gs://", "gcs://"):
        if dst.startswith(scheme):
            rest = dst[len(scheme):]
            bucket, _, prefix = rest.partition("/")
            return GcsRemote(bucket, prefix, **kw)
    if dst.startswith("azblob://"):
        rest = dst[9:]
        container, _, prefix = rest.partition("/")
        return AzblobRemote(container, prefix, **kw)
    raise ValueError(f"unsupported backup destination {dst!r} "
                     "(supported: fs://, s3://, gs://, azblob://)")


def _local_files(root: str) -> dict[str, int]:
    out = {}
    for dp, _, fns in os.walk(root):
        for fn in fns:
            full = os.path.join(dp, fn)
            out[os.path.relpath(full, root)] = os.path.getsize(full)
    return out


def backup(snapshot_path: str, remote: RemoteFS) -> dict:
    """Incremental: upload only new/changed files, delete removed ones
    (immutable parts mean same name+size => same content)."""
    local = _local_files(snapshot_path)
    existing = remote.list_files()
    uploaded = skipped = deleted = 0
    for rel, size in local.items():
        if existing.get(rel) == size:
            skipped += 1
            continue
        remote.upload(rel, os.path.join(snapshot_path, rel))
        uploaded += 1
    for rel in existing:
        if rel not in local:
            remote.delete(rel)
            deleted += 1
    logger.infof("backup: uploaded=%d skipped=%d deleted=%d",
                 uploaded, skipped, deleted)
    return {"uploaded": uploaded, "skipped": skipped, "deleted": deleted}


def restore(remote: RemoteFS, storage_data_path: str) -> dict:
    """Restore into an (empty or partial) storage dir, skipping files that
    already match (hardlink-reuse analog)."""
    local = _local_files(storage_data_path) if os.path.isdir(
        storage_data_path) else {}
    remote_files = remote.list_files()
    downloaded = skipped = removed = 0
    for rel, size in remote_files.items():
        if local.get(rel) == size:
            skipped += 1
            continue
        remote.download(rel, os.path.join(storage_data_path, rel))
        downloaded += 1
    for rel in local:
        if rel not in remote_files:
            os.unlink(os.path.join(storage_data_path, rel))
            removed += 1
    logger.infof("restore: downloaded=%d skipped=%d removed=%d",
                 downloaded, skipped, removed)
    return {"downloaded": downloaded, "skipped": skipped, "removed": removed}


def create_snapshot_via_http(addr: str) -> str:
    with urllib.request.urlopen(addr.rstrip("/") + "/snapshot/create",
                                timeout=60) as r:
        return json.loads(r.read())["snapshot"]


def main_backup(argv=None):
    p = argparse.ArgumentParser(prog="vmbackup")
    p.add_argument("-storageDataPath", required=True)
    p.add_argument("-snapshotName", default="")
    p.add_argument("-snapshot.createURL", dest="create_url", default="")
    p.add_argument("-dst", required=True)
    args, _ = p.parse_known_args(argv)
    name = args.snapshotName
    if not name and args.create_url:
        name = create_snapshot_via_http(args.create_url)
    if not name:
        raise SystemExit("need -snapshotName or -snapshot.createURL")
    snap = os.path.join(args.storageDataPath, "snapshots", name)
    backup(snap, open_remote(args.dst))


def main_restore(argv=None):
    p = argparse.ArgumentParser(prog="vmrestore")
    p.add_argument("-src", required=True)
    p.add_argument("-storageDataPath", required=True)
    args, _ = p.parse_known_args(argv)
    restore(open_remote(args.src), args.storageDataPath)


if __name__ == "__main__":
    main_backup()
