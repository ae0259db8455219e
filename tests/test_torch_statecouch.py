"""The port's CouchDB state mirror (ledger/statecouch) against the JAX
package's, over an in-process fake CouchDB.

The fake is tests/test_statecouch.py's, copied, with a log of every request
(method, path, raw body). The same UpdateBatches, reads, range scans and
queries go through both packages' adapters, each against a fresh fake: the
request logs are equal byte for byte (`_bulk_docs`, `_all_docs` and `_find`
bodies, their key order and separators included), and so are the answers
and the stored documents. A KVLedger with `state_mirror=` leaves the same
documents in both packages, and a mirror that fails does not fail the
commit in either."""

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

import pytest

from fabric_tpu.ledger import kvledger as jkv
from fabric_tpu.ledger import rwset as jrw
from fabric_tpu.ledger import statecouch as jsc
from fabric_tpu.ledger import statedb as jsdb
from fabric_tpu.protos import common_pb2
from fabric_tpu_torch.ledger import kvledger as tkv
from fabric_tpu_torch.ledger import rwset as trw
from fabric_tpu_torch.ledger import statecouch as tsc
from fabric_tpu_torch.ledger import statedb as tsdb
from fabric_tpu_torch.protos import fabric, protoutil, wire


class FakeCouch(BaseHTTPRequestHandler):
    """Enough of CouchDB's dialect for the adapter: per-db doc stores
    with MVCC _rev checking, _bulk_docs, _all_docs, _find."""

    dbs: dict = {}
    revs: dict = {}
    find_calls: list = []
    bulk_get_counter: list = []
    requests: list = []  # (method, path, raw body) of every request

    def log_message(self, *a):  # quiet
        pass

    @staticmethod
    def _maybe_stub(doc, inline):
        """Real CouchDB returns attachment STUBS unless asked to
        inline (and /_find can never inline) — the adapter must cope."""
        if inline or not doc.get("_attachments"):
            return doc
        out = dict(doc)
        out["_attachments"] = {
            name: {k: v for k, v in att.items() if k != "data"}
            | {"stub": True, "length": 1}
            for name, att in doc["_attachments"].items()
        }
        return out

    def _json(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b""
        type(self).requests.append(("POST", self.path, raw))
        return json.loads(raw) if n else {}

    def do_PUT(self):
        db = self.path.strip("/")
        cls = type(self)
        cls.requests.append(("PUT", self.path, b""))
        if db in cls.dbs:
            self._json(412, {"error": "file_exists"})
        else:
            cls.dbs[db] = {}
            cls.revs[db] = {}
            self._json(201, {"ok": True})

    def do_GET(self):
        cls = type(self)
        cls.requests.append(("GET", self.path, b""))
        parsed = urlparse(self.path)
        parts = parsed.path.strip("/").split("/")
        if len(parts) == 2 and parts[1] == "_all_docs":
            qs = parse_qs(parsed.query)
            docs = cls.dbs.get(parts[0], {})
            keys = sorted(docs)
            start = json.loads(qs["startkey"][0]) if "startkey" in qs else None
            end = json.loads(qs["endkey"][0]) if "endkey" in qs else None
            rows = []
            for k in keys:
                if start is not None and k < start:
                    continue
                if end is not None and k >= end:
                    continue
                row = {
                    "id": k,
                    "value": {"rev": cls.revs[parts[0]][k]},
                }
                if qs.get("include_docs") == ["true"]:
                    row["doc"] = self._maybe_stub(
                        docs[k], qs.get("attachments") == ["true"]
                    )
                rows.append(row)
            if "limit" in qs:
                rows = rows[: int(qs["limit"][0])]
            self._json(200, {"rows": rows})
            return
        if len(parts) == 2:
            db, key = parts[0], unquote(parts[1])
            doc = cls.dbs.get(db, {}).get(key)
            if doc is None:
                self._json(404, {"error": "not_found"})
            else:
                self._json(200, doc)
            return
        self._json(404, {"error": "not_found"})

    def do_POST(self):
        cls = type(self)
        parts = self.path.strip("/").split("/")
        db = parts[0]
        body = self._body()
        if parts[1] == "_bulk_docs":
            cls.bulk_get_counter.append(len(body.get("docs", [])))
            out = []
            for doc in body["docs"]:
                key = doc["_id"]
                current_rev = cls.revs[db].get(key)
                given = doc.get("_rev")
                if current_rev is not None and given != current_rev:
                    out.append({"id": key, "error": "conflict"})
                    continue
                n = int((current_rev or "0-x").split("-")[0]) + 1
                rev = f"{n}-{'%08x' % abs(hash(key)) }"[:14]
                if doc.get("_deleted"):
                    cls.dbs[db].pop(key, None)
                    cls.revs[db].pop(key, None)
                    out.append({"id": key, "ok": True, "rev": rev})
                    continue
                stored = {
                    k: v for k, v in doc.items() if k not in ("_rev",)
                }
                stored["_rev"] = rev
                cls.dbs[db][key] = stored
                cls.revs[db][key] = rev
                out.append({"id": key, "ok": True, "rev": rev})
            self._json(201, out)
            return
        if parts[1] == "_all_docs":
            rows = []
            for k in body.get("keys", []):
                rev = cls.revs.get(db, {}).get(k)
                if rev is None:
                    rows.append({"key": k, "error": "not_found"})
                else:
                    rows.append({"id": k, "value": {"rev": rev}})
            self._json(200, {"rows": rows})
            return
        if parts[1] == "_find":
            cls.find_calls.append(body)
            selector = body.get("selector", {})
            docs = []
            for k in sorted(cls.dbs.get(db, {})):
                doc = cls.dbs[db][k]
                ok = True
                for field, cond in selector.items():
                    val = doc.get(field)
                    if isinstance(cond, dict):
                        for op, ref in cond.items():
                            if op == "$gt" and not (
                                val is not None and val > ref
                            ):
                                ok = False
                            if op == "$lt" and not (
                                val is not None and val < ref
                            ):
                                ok = False
                    elif val != cond:
                        ok = False
                if ok:
                    docs.append(doc)
            docs = [self._maybe_stub(d, False) for d in docs]
            offset = 0
            if body.get("bookmark"):
                offset = int(
                    base64.b64decode(body["bookmark"]).decode()
                )
            limit = body.get("limit", 25)  # CouchDB's silent default
            page = docs[offset : offset + limit]
            bookmark = base64.b64encode(
                str(offset + len(page)).encode()
            ).decode()
            self._json(200, {"docs": page, "bookmark": bookmark})
            return
        self._json(404, {"error": "not_found"})



def reset_fake():
    FakeCouch.dbs, FakeCouch.revs = {}, {}
    FakeCouch.find_calls, FakeCouch.bulk_get_counter, FakeCouch.requests = [], [], []


@pytest.fixture
def couch_url():
    reset_fake()
    server = ThreadingHTTPServer(("127.0.0.1", 0), FakeCouch)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()
    t.join()


def run_both(url, script):
    """`script(sc, rw, sdb, url)` once a package, each against a fresh fake:
    [(its result, the request log, the stored documents)] JAX first."""
    out = []
    for sc, rw, sdb in ((jsc, jrw, jsdb), (tsc, trw, tsdb)):
        reset_fake()
        result = script(sc, rw, sdb, url)
        out.append((result, list(FakeCouch.requests), json.loads(json.dumps(FakeCouch.dbs))))
    return out


BLOCKS = [
    [("json1", json.dumps({"owner": "alice", "qty": 3}).encode()), ("bin1", b"\x00\x01binary"),
     ("under", b'{"_id": "x"}'), ("tilde", b'{"~v": 1}'), ("list", b"[1, 2]"),
     ("utf", "caf\u00e9 \u2603".encode()), ("bad-utf", b"\xff\xfe"), ("num", b"17"),
     ("md", b"v", b"\x0a\x04note")],
    [(f"k{i}", b"v1") for i in range(5)] + [("json1", b'{"owner": "bob", "qty": 4}')],
    [(f"k{i}", b"v2") for i in range(5)] + [("k0", None), ("bin1", None), ("ghost", None)],
]


def commit(adapter, rw, sdb, number, entries, ns="cc"):
    batch = sdb.UpdateBatch()
    for t, entry in enumerate(entries):
        key, value, md = (entry + (None,))[:3]
        if value is None:
            batch.delete(ns, key, rw.Version(number, t))
        else:
            batch.put(ns, key, value, rw.Version(number, t), md)
    adapter.apply_updates(batch)


def vv(v):
    return None if v is None else (v.value, (v.version.block_num, v.version.tx_num), v.metadata)


def test_same_requests_documents_and_answers(couch_url):
    def script(sc, rw, sdb, url):
        a = sc.CouchStateAdapter(sc.CouchClient(url), "MyChannel")
        for number, entries in enumerate(BLOCKS):
            commit(a, rw, sdb, number + 1, entries)
        # a restarted adapter: its revisions come from one bulk preload
        b = sc.CouchStateAdapter(sc.CouchClient(url), "MyChannel")
        commit(b, rw, sdb, 4, [("k3", b"v4"), ("new", b'{"owner": "alice", "qty": 9}')])
        # a stale cache: the commit conflicts once, refreshes and retries
        commit(a, rw, sdb, 5, [("k3", b"v5")])
        keys = ["json1", "bin1", "under", "tilde", "list", "utf", "bad-utf", "num", "md", "k0",
                "k3", "new", "ghost"]
        reads = {k: vv(b.get_state("cc", k)) for k in keys}
        versions = {k: b.get_version("cc", k) for k in ("k3", "ghost")}
        ranges = [[(k, vv(v)) for k, v in b.get_state_range("cc", s, e, limit)]
                  for s, e, limit in (("k1", "k4", None), ("", "", None), ("a", "", 3))]
        sel = {"owner": "alice", "qty": {"$gt": 1}}
        page1, bm1 = b.execute_query("cc", sel, page_size=1)
        page2, bm2 = b.execute_query("cc", sel, page_size=1, bookmark=bm1)
        every, _ = b.execute_query("cc", {})
        return (reads, {k: None if v is None else (v.block_num, v.tx_num)
                        for k, v in versions.items()},
                ranges, (page1, bm1, page2, bm2), every)

    (jres, jreq, jdocs), (tres, treq, tdocs) = run_both(couch_url, script)
    assert treq == jreq
    assert tdocs == jdocs
    assert tres == jres
    reads = tres[0]
    assert reads["bin1"] is None and reads["k0"] is None and reads["md"][2] == b"\x0a\x04note"
    assert reads["bad-utf"][0] == b"\xff\xfe" and reads["k3"][0] == b"v5"
    # every kind of request went out: database creation, bulk docs, the
    # bulk revision preload, point reads, range scans and /_find
    last = [p.split("?")[0].split("/")[-1] for _, p, _ in treq]
    kinds = {(m, seg if seg.startswith("_") else "doc") for (m, _, _), seg in zip(treq, last)}
    assert {("PUT", "doc"), ("POST", "_bulk_docs"), ("POST", "_all_docs"), ("GET", "_all_docs"),
            ("POST", "_find")} <= kinds


def test_db_name_mangling_equal():
    for channel, ns in (("MyChannel", "MyCC"), ("ch", "cc.v2"), ("ch", ""), ("A b", "x@y:z"),
                        ("ch", "_lifecycle"), ("ch", "caf\u00e9")):
        assert tsc.couch_db_name(channel, ns) == jsc.couch_db_name(channel, ns)


def test_client_errors_equal(couch_url):
    def script(sc, rw, sdb, url):
        client = sc.CouchClient(url)
        out = []
        for call in (lambda: client.bulk_docs("nodb", []),
                     lambda: client.find("nodb", {"selector": {}}),
                     lambda: sc.CouchClient("http://127.0.0.1:1").ensure_db("x")):
            try:
                out.append(("ok", call()))
            except sc.CouchError as exc:
                out.append(("error", str(exc).split(":")[0]))
        client.ensure_db("db")
        client.ensure_db("db")  # 412 file_exists is not an error
        out.append(client.get_doc("db", "missing"))
        return out

    (jres, jreq, _), (tres, treq, _) = run_both(couch_url, script)
    assert tres == jres and treq == jreq


def _block(number, prev, n_txs):
    """A JAX block of `n_txs` placeholder envelopes, every tx VALID."""
    from fabric_tpu.protos import protoutil as jpu

    block = jpu.new_block(number, prev)
    for _ in range(n_txs):
        block.data.data.append(b"\x00")
    jpu.seal_block(block)
    jpu.init_block_metadata(block)
    block.metadata.metadata[common_pb2.TRANSACTIONS_FILTER] = bytes(n_txs)  # VALID
    return block


LEDGER_TXS = [
    [("cc", [("a", b'{"owner": "alice"}'), ("bin", b"\x01\x02")]), ("cc2", [("z", b"1")])],
    [("cc", [("a", b'{"owner": "bob"}'), ("bin", None)])],
    [],  # a block with no public writes: nothing goes to the mirror
    [("cc", [("c", b"3")])],
]


def _rwsets(rw, txs):
    return [rw.TxRwSet((rw.NsRwSet(ns, (), tuple(
        rw.KVWrite(k, v is None, b"" if v is None else v) for k, v in writes)),))
        for ns, writes in txs]


def test_kvledger_mirror_same_documents_and_outage(couch_url, tmp_path):
    """Both ledgers, each with a mirror, commit the same blocks: the same
    requests and documents; then the mirror's endpoint goes away and the
    next commit still lands in both."""
    from fabric_tpu.protos import protoutil as jpu

    raws, prev = [], b""
    for number, txs in enumerate(LEDGER_TXS):
        jb = _block(number, prev, max(len(txs), 1))
        prev = jpu.block_header_hash(jb.header)
        raws.append(jb.SerializeToString())
    outage = _block(len(LEDGER_TXS), prev, 1).SerializeToString()

    def script(sc, rw, sdb, url):
        port = sc is tsc
        mirror = sc.CouchStateAdapter(sc.CouchClient(url), "mych")
        path = tmp_path / ("port" if port else "jax")
        ledger = (tkv if port else jkv).KVLedger(str(path), "mych", state_mirror=mirror)
        hashes = []
        try:
            for raw, txs in zip(raws + [outage], LEDGER_TXS + [[("cc", [("k2", b"v")])]]):
                if raw is outage:
                    mirror.client.base = "http://127.0.0.1:1"
                rwsets = _rwsets(rw, txs) or [None]
                if port:
                    b = wire.decode(fabric.BLOCK, raw)
                    ledger.commit(b, rwsets=rwsets)
                    hashes.append(b["metadata"]["metadata"][fabric.COMMIT_HASH])
                else:
                    b = common_pb2.Block.FromString(raw)
                    ledger.commit(b, rwsets=rwsets)
                    hashes.append(b.metadata.metadata[common_pb2.COMMIT_HASH])
            return hashes, ledger.get_state("cc", "k2"), ledger.height
        finally:
            ledger.close()

    (jres, jreq, jdocs), (tres, treq, tdocs) = run_both(couch_url, script)
    assert tres == jres and tres[1] == b"v" and tres[2] == len(LEDGER_TXS) + 1
    assert treq == jreq and tdocs == jdocs
    assert tdocs["mych_cc"]["a"]["owner"] == "bob" and "bin" not in tdocs["mych_cc"]
    assert "k2" not in tdocs["mych_cc"]  # the outage: not mirrored, still committed
    assert ((tmp_path / "port" / "mych.chain").read_bytes()
            == (tmp_path / "jax" / "mych.chain").read_bytes())
