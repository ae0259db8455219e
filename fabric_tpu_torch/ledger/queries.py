"""Rich (selector) queries over JSON state values.

The reference delegates rich queries to CouchDB's Mango selector language
(reference core/ledger/kvledger/txmgmt/statedb/statecouchdb/statecouchdb.go:695
ExecuteQuery; query syntax per CouchDB /_find). Here the selector engine is
embedded: the same JSON selector documents are evaluated directly over the
namespace's rows, so rich queries need no external database. Like the
reference, rich-query results are NOT phantom-protected — they add no
range read to the rwset (documented Fabric behavior for CouchDB queries).

Supported (the subset Fabric chaincodes actually use): implicit-AND field
matches, dotted paths, $eq $ne $gt $gte $lt $lte $in $nin $exists $regex
$size $type, combinators $and $or $not $nor, arrays via $elemMatch, plus
top-level limit / skip / sort / fields.

A copy of the JAX package's `ledger/queries` (it imports nothing of it).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple


class QueryError(ValueError):
    """Malformed selector document."""


_TYPE_NAMES = {
    "null": type(None),
    "boolean": bool,
    "number": (int, float),
    "string": str,
    "array": list,
    "object": dict,
}


def parse_query(query) -> Dict[str, Any]:
    """Query string/dict -> normalized {selector, limit, skip, sort, fields}."""
    if isinstance(query, (str, bytes)):
        try:
            query = json.loads(query)
        except json.JSONDecodeError as e:
            raise QueryError(f"invalid query JSON: {e}") from e
    if not isinstance(query, dict):
        raise QueryError("query must be a JSON object")
    if "selector" not in query:
        raise QueryError('query missing "selector"')
    out = {
        "selector": query["selector"],
        "limit": query.get("limit"),
        "skip": query.get("skip", 0),
        "sort": query.get("sort"),
        "fields": query.get("fields"),
    }
    if not isinstance(out["selector"], dict):
        raise QueryError("selector must be an object")
    return out


def _lookup(doc: Any, path: str):
    """Dotted-path lookup; returns (found, value)."""
    cur = doc
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return False, None
    return True, cur


def _cmp_ok(a, b) -> bool:
    """CouchDB compares within type families; cross-type comparisons
    simply don't match here."""
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool)
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return True
    return type(a) is type(b) and isinstance(a, (str, int, float))


def _match_op(op: str, cond, value, found: bool) -> bool:
    if op == "$exists":
        return found is bool(cond) or found == bool(cond)
    if not found:
        return False
    if op == "$eq":
        return value == cond
    if op == "$ne":
        return value != cond
    if op in ("$gt", "$gte", "$lt", "$lte"):
        if not _cmp_ok(value, cond):
            return False
        if op == "$gt":
            return value > cond
        if op == "$gte":
            return value >= cond
        if op == "$lt":
            return value < cond
        return value <= cond
    if op == "$in":
        return isinstance(cond, list) and value in cond
    if op == "$nin":
        return isinstance(cond, list) and value not in cond
    if op == "$regex":
        return isinstance(value, str) and re.search(cond, value) is not None
    if op == "$size":
        return isinstance(value, list) and len(value) == cond
    if op == "$type":
        t = _TYPE_NAMES.get(cond)
        if t is None:
            raise QueryError(f"unknown $type {cond!r}")
        if cond == "number":
            return isinstance(value, t) and not isinstance(value, bool)
        return isinstance(value, t)
    if op == "$elemMatch":
        return isinstance(value, list) and any(
            matches(cond, el) if isinstance(el, dict) else _field_match(el, cond)
            for el in value
        )
    raise QueryError(f"unsupported operator {op!r}")


def _field_match(value, cond) -> bool:
    """Scalar-vs-condition for $elemMatch over scalar arrays."""
    if isinstance(cond, dict):
        return all(_match_op(op, c, value, True) for op, c in cond.items())
    return value == cond


def matches(selector: Dict[str, Any], doc: Any) -> bool:
    """Does `doc` satisfy `selector` (implicit AND across entries)?"""
    for field, cond in selector.items():
        if field == "$and":
            if not all(matches(s, doc) for s in cond):
                return False
        elif field == "$or":
            if not any(matches(s, doc) for s in cond):
                return False
        elif field == "$nor":
            if any(matches(s, doc) for s in cond):
                return False
        elif field == "$not":
            if matches(cond, doc):
                return False
        elif field.startswith("$"):
            raise QueryError(f"unsupported combinator {field!r}")
        else:
            found, value = _lookup(doc, field)
            if isinstance(cond, dict) and any(
                k.startswith("$") for k in cond
            ):
                for op, c in cond.items():
                    if not _match_op(op, c, value, found):
                        return False
            else:
                if not found or value != cond:
                    return False
    return True


def execute(
    rows: Iterable[Tuple[str, bytes]], query
) -> List[Tuple[str, bytes]]:
    """Run a parsed/raw query over (key, value_bytes) rows. Non-JSON
    values never match (CouchDB stores them as attachments, invisible to
    selectors). Returns (key, value_bytes) with `fields` projection
    applied to the returned JSON when requested."""
    q = parse_query(query)
    selector = q["selector"]
    hits: List[Tuple[str, bytes, Any]] = []
    for key, raw in rows:
        try:
            doc = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            continue
        if not isinstance(doc, dict):
            continue
        if matches(selector, doc):
            hits.append((key, raw, doc))

    if q["sort"]:
        for spec in reversed(q["sort"]):
            if isinstance(spec, str):
                field, direction = spec, "asc"
            else:
                (field, direction), = spec.items()
            hits.sort(
                key=lambda h, f=field: _sort_key(h[2], f),
                reverse=(direction == "desc"),
            )
    if q["skip"]:
        hits = hits[q["skip"]:]
    if q["limit"] is not None:
        hits = hits[: q["limit"]]

    out: List[Tuple[str, bytes]] = []
    for key, raw, doc in hits:
        if q["fields"]:
            proj = {f: doc[f] for f in q["fields"] if f in doc}
            out.append((key, json.dumps(proj, sort_keys=True).encode()))
        else:
            out.append((key, raw))
    return out


def _sort_key(doc, field):
    found, v = _lookup(doc, field)
    # sort groups: missing < null < bool < number < string
    if not found:
        return (0, 0)
    if v is None:
        return (1, 0)
    if isinstance(v, bool):
        return (2, v)
    if isinstance(v, (int, float)):
        return (3, v)
    if isinstance(v, str):
        return (4, v)
    return (5, json.dumps(v))


# ---------------------------------------------------------------------------
# bookmark pagination (reference statecouchdb.go:567 range pagination /
# :653 ExecuteQueryWithPagination; chaincode GetQueryResultWithPagination)
# ---------------------------------------------------------------------------


def encode_bookmark(offset: int) -> str:
    """Opaque resumption token (CouchDB bookmarks are opaque strings; here
    the payload is the count of result rows already consumed)."""
    import base64

    return base64.urlsafe_b64encode(
        json.dumps({"o": offset}).encode()
    ).decode()


def decode_bookmark(bookmark: str) -> int:
    import base64

    if not bookmark:
        return 0
    try:
        doc = json.loads(base64.urlsafe_b64decode(bookmark.encode()))
        offset = doc["o"]
        if not isinstance(offset, int) or offset < 0:
            raise ValueError
        return offset
    except Exception as e:  # noqa: BLE001
        raise QueryError(f"invalid bookmark {bookmark!r}") from e


def execute_paginated(
    rows: Iterable[Tuple[str, bytes]],
    query,
    page_size: int,
    bookmark: str = "",
) -> Tuple[List[Tuple[str, bytes]], str]:
    """One page of rich-query results plus the next bookmark.

    The page size overrides any `limit`/`skip` in the query document
    (the reference rejects limit+pagination together,
    statecouchdb.go:700 validateQueryMetadata; skip is ignored in favor
    of the bookmark).  The returned bookmark resumes after the last
    returned row; passing it back with the same query and a stable
    snapshot yields the next page.  An exhausted result set returns the
    bookmark pointing past the end (fetched count < page_size tells the
    caller to stop, as with CouchDB)."""
    if page_size <= 0:
        raise QueryError("pageSize must be a positive integer")
    q = parse_query(query)
    if q["limit"] is not None or q["skip"]:
        raise QueryError(
            "limit/skip cannot be combined with pagination (use the "
            "bookmark + pageSize contract)"
        )
    offset = decode_bookmark(bookmark)
    all_hits = execute(
        rows,
        {"selector": q["selector"], "sort": q["sort"], "fields": q["fields"]},
    )
    page = all_hits[offset : offset + page_size]
    return page, encode_bookmark(offset + len(page))
