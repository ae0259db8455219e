"""CouchDB-compatible REST state adapter (reference core/ledger/
kvledger/txmgmt/statedb/statecouchdb/statecouchdb.go).

The port's counterpart of the JAX package's `ledger/statecouch`: the same
documents, the same request paths and the same JSON bodies (key order and
separators included), over `urllib` with no other dependency. The embedded
SQLite store (`ledger/persistent.py`) is the port's state backend and
already serves rich selector queries + bookmark pagination
(`ledger/queries.py`); what it cannot offer is the reference's operational
story: an external CouchDB a deployment already runs, with its own
replication, backup and inspection tooling. This adapter speaks that REST
dialect for the public-state surface:

* one database per (channel, namespace), named like the reference's
  `<channel>_<namespace>` (couchdb dbname mangling);
* documents are `{_id: key, ~version: "h:t", ...json fields}` with a
  `_attachments.valueBytes` for non-JSON values, byte-compatible with
  what the reference writes, so a Fabric-populated CouchDB reads back
  verbatim;
* commits go through `_bulk_docs` with the reference's revision cache
  (statecouchdb.go:695 bulk-preload: one `_all_docs?keys=` round trip
  fetches the _revs of every key the block writes, instead of one GET
  per key);
* range scans ride `_all_docs?startkey&endkey&limit`, rich queries pass
  the selector to `/_find` verbatim with CouchDB's own opaque bookmark
  flowing back to the client.

Hashed/private collections, history and the commit-hash chain stay on the
embedded store; this adapter is the operational mirror of the public
state (`KVLedger(state_mirror=)`, applied after each commit, best effort).
"""

from __future__ import annotations

import base64
import json
import urllib.parse
import urllib.request
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from fabric_tpu_torch.ledger.rwset import Version
from fabric_tpu_torch.ledger.statedb import UpdateBatch, VersionedValue


class CouchError(Exception):
    pass


def _version_str(v: Version) -> str:
    return f"{v.block_num}:{v.tx_num}"


def _parse_version(s: str) -> Version:
    h, _, t = s.partition(":")
    return Version(int(h), int(t))


def couch_db_name(channel: str, ns: str) -> str:
    """The reference's mangling (couchdbutil CreateCouchDatabase):
    lowercase, [a-z0-9_$()+/-] only, `<channel>_<ns>`."""
    raw = f"{channel}_{ns}".lower() if ns else channel.lower()
    return "".join(
        c if c.isalnum() or c in "_$()+-/" else "$" for c in raw
    )


class CouchClient:
    """Minimal CouchDB REST client over urllib. Every method raises
    CouchError on a status other than 2xx, 404 and a 412 from PUT /{db}."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    def _req(
        self, method: str, path: str, body: Optional[dict] = None
    ) -> dict:
        data = None
        headers = {"Accept": "application/json"}
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(
            f"{self.base}{path}", data=data, method=method, headers=headers
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return {"_not_found": True}
            if exc.code == 412:
                # PUT /{db} on an existing database (file_exists)
                try:
                    return json.loads(exc.read() or b"{}")
                except ValueError:
                    return {"error": "file_exists"}
            raise CouchError(
                f"{method} {path} -> {exc.code}: {exc.read()[:200]}"
            ) from exc
        except OSError as exc:
            raise CouchError(f"{method} {path}: {exc}") from exc

    def ensure_db(self, db: str) -> None:
        out = self._req("PUT", f"/{db}")
        if out.get("error") not in (None, "file_exists"):
            raise CouchError(f"create {db}: {out}")

    def get_doc(self, db: str, key: str) -> Optional[dict]:
        out = self._req(
            "GET",
            f"/{db}/{urllib.parse.quote(key, safe='')}?attachments=true",
        )
        return None if out.get("_not_found") else out

    def bulk_docs(self, db: str, docs: List[dict]) -> List[dict]:
        out = self._req("POST", f"/{db}/_bulk_docs", {"docs": docs})
        if isinstance(out, dict):
            raise CouchError(f"_bulk_docs: {out}")
        return out

    def all_docs(
        self,
        db: str,
        *,
        keys: Optional[List[str]] = None,
        startkey: Optional[str] = None,
        endkey: Optional[str] = None,
        limit: Optional[int] = None,
        include_docs: bool = False,
    ) -> dict:
        if keys is not None:
            return self._req("POST", f"/{db}/_all_docs", {"keys": keys})
        params = []
        if startkey is not None:
            params.append(("startkey", json.dumps(startkey)))
        if endkey is not None:
            # exclusive end bound like the reference's range scans
            params.append(("endkey", json.dumps(endkey)))
            params.append(("inclusive_end", "false"))
        if limit is not None:
            params.append(("limit", str(limit)))
        if include_docs:
            params.append(("include_docs", "true"))
            # attachment DATA, not stubs: binary values must round-trip
            # through scans exactly like point reads
            params.append(("attachments", "true"))
        qs = "&".join(f"{k}={urllib.parse.quote(v)}" for k, v in params)
        return self._req("GET", f"/{db}/_all_docs" + (f"?{qs}" if qs else ""))

    def find(self, db: str, body: dict) -> dict:
        out = self._req("POST", f"/{db}/_find", body)
        if "docs" not in out:
            raise CouchError(f"_find: {out}")
        return out


def _to_doc(key: str, value: bytes, version: Version, metadata=None) -> dict:
    """Reference doc shape (couchdoc_conv.go): JSON values inline,
    binary under the valueBytes attachment."""
    doc: dict = {"_id": key, "~version": _version_str(version)}
    try:
        fields = json.loads(value)
        if not isinstance(fields, dict) or any(
            k.startswith(("_", "~")) for k in fields
        ):
            raise ValueError
        doc.update(fields)
    except (ValueError, UnicodeDecodeError):
        doc["_attachments"] = {
            "valueBytes": {
                "content_type": "application/octet-stream",
                "data": base64.b64encode(value).decode(),
            }
        }
    if metadata:
        doc["~metadata"] = base64.b64encode(metadata).decode()
    return doc


def _from_doc(doc: dict) -> VersionedValue:
    version = _parse_version(doc["~version"])
    att = (doc.get("_attachments") or {}).get("valueBytes")
    if att is not None and "data" in att:
        value = base64.b64decode(att["data"])
    else:
        fields = {
            k: v
            for k, v in doc.items()
            if not k.startswith(("_", "~"))
        }
        value = json.dumps(fields, sort_keys=True).encode()
    md = doc.get("~metadata")
    return VersionedValue(
        value, version, base64.b64decode(md) if md else None
    )


def _has_attachment_stub(doc: dict) -> bool:
    """True when a doc carries attachment stubs (no inline data): the
    /_find endpoint can never inline attachments, so binary values need
    a follow-up point read (the reference statecouchdb re-fetches the
    same way)."""
    atts = doc.get("_attachments") or {}
    return any("data" not in a for a in atts.values())


class CouchStateAdapter:
    """Public-state operational mirror over one CouchDB endpoint."""

    # explicit limit on every /_find: CouchDB's silent default is 25,
    # which would truncate unpaginated queries (the reference sets
    # internalQueryLimit, default 1000, on every query)
    QUERY_LIMIT = 1000

    def __init__(self, client: CouchClient, channel: str):
        self.client = client
        self.channel = channel
        self._dbs: Dict[str, str] = {}
        # revision cache (statecouchdb.go committedDataCache): _id -> _rev
        self._revs: Dict[Tuple[str, str], str] = {}

    def _db(self, ns: str) -> str:
        db = self._dbs.get(ns)
        if db is None:
            db = couch_db_name(self.channel, ns)
            self.client.ensure_db(db)
            self._dbs[ns] = db
        return db

    # -- reads -------------------------------------------------------------
    def get_state(self, ns: str, key: str) -> Optional[VersionedValue]:
        doc = self.client.get_doc(self._db(ns), key)
        if doc is None:
            return None
        self._revs[(ns, key)] = doc.get("_rev", "")
        return _from_doc(doc)

    def get_version(self, ns: str, key: str) -> Optional[Version]:
        vv = self.get_state(ns, key)
        return vv.version if vv else None

    def get_state_range(
        self, ns: str, start: str, end: str, limit: Optional[int] = None
    ) -> Iterator[Tuple[str, VersionedValue]]:
        out = self.client.all_docs(
            self._db(ns),
            startkey=start or None,
            endkey=end or None,
            limit=limit,
            include_docs=True,
        )
        for row in out.get("rows", []):
            doc = row.get("doc")
            if doc:
                if _has_attachment_stub(doc):
                    doc = self.client.get_doc(self._db(ns), row["id"]) or doc
                yield row["id"], _from_doc(doc)

    def execute_query(
        self,
        ns: str,
        selector: dict,
        page_size: Optional[int] = None,
        bookmark: str = "",
    ) -> Tuple[List[Tuple[str, bytes]], str]:
        """Selector passes to /_find verbatim; CouchDB's opaque bookmark
        flows back: a cursor that survives a restarted iterator, which the
        embedded store's offset tokens do not give."""
        body: dict = {"selector": selector, "limit": page_size or self.QUERY_LIMIT}
        if bookmark:
            body["bookmark"] = bookmark
        out = self.client.find(self._db(ns), body)
        rows = []
        for doc in out["docs"]:
            if _has_attachment_stub(doc):
                # /_find cannot inline attachments: binary values need a
                # point re-read (statecouchdb executeQueryWithBookmark)
                doc = self.client.get_doc(self._db(ns), doc["_id"]) or doc
            vv = _from_doc(doc)
            rows.append((doc["_id"], vv.value))
        return rows, out.get("bookmark", "")

    # -- commit ------------------------------------------------------------
    def preload_revisions(self, ns: str, keys: Sequence[str]) -> None:
        """Bulk-preload the revision cache for a block's written keys
        (statecouchdb.go:695): one _all_docs round trip instead of a GET
        per key."""
        missing = [k for k in keys if (ns, k) not in self._revs]
        if not missing:
            return
        out = self.client.all_docs(self._db(ns), keys=list(missing))
        for row in out.get("rows", []):
            rev = (row.get("value") or {}).get("rev")
            if rev and not (row.get("value") or {}).get("deleted"):
                self._revs[(ns, row["id"])] = rev

    def apply_updates(self, batch: UpdateBatch) -> None:
        """Block commit: per-namespace _bulk_docs with cached _revs;
        conflicts refresh the cache and retry once (the reference's
        retry loop on sporadic revision conflicts)."""
        by_ns: Dict[str, List[Tuple[str, object]]] = {}
        for (ns, key), entry in batch.items():
            by_ns.setdefault(ns, []).append((key, entry))
        for ns, entries in by_ns.items():
            self.preload_revisions(ns, [k for k, _e in entries])
            self._flush_ns(ns, entries, retry=True)

    def _flush_ns(self, ns: str, entries, retry: bool) -> None:
        docs = []
        for key, entry in entries:
            if entry.value is None:
                doc = {"_id": key, "_deleted": True}
            else:
                doc = _to_doc(key, entry.value, entry.version, entry.metadata)
            rev = self._revs.get((ns, key))
            if rev:
                doc["_rev"] = rev
            docs.append(doc)
        results = self.client.bulk_docs(self._db(ns), docs)
        conflicts = []
        for res in results:
            key = res.get("id")
            if res.get("ok"):
                if res.get("rev"):
                    self._revs[(ns, key)] = res["rev"]
                continue
            if res.get("error") == "conflict" and retry:
                self._revs.pop((ns, key), None)
                conflicts.append(key)
            else:
                raise CouchError(f"bulk update {ns}/{key}: {res}")
        if conflicts:
            entry_map = dict(entries)
            self.preload_revisions(ns, conflicts)
            self._flush_ns(
                ns, [(k, entry_map[k]) for k in conflicts], retry=False
            )
