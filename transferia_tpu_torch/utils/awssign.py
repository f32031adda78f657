"""AWS Signature Version 4 for REST requests (the port's copy of
``transferia_tpu/utils/awssign.py``): the S3 client, the S3 coordinator,
the staged S3 sink and the SQS client sign through it.  hashlib and hmac
only, no SDK.

Reference behavior being matched: the aws-sdk-go signer used by
pkg/coordinator/s3coordinator/coordinator_s3.go:355-375.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
from typing import Optional


def _hm(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def canonical_query(query: dict[str, str]) -> str:
    """SigV4 canonical query string.

    Clients must put EXACTLY this string on the wire: urlencode()'s
    quote_plus form ('+' for space) differs from the canonical '%20' and
    the server's recomputed signature would not match.
    """
    return "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(str(v), safe='-_.~')}"
        for k, v in sorted(query.items())
    )


def sign_request(method: str, host: str, path: str,
                 query: dict[str, str], headers: dict[str, str],
                 body: bytes, region: str, service: str,
                 access_key: str, secret_key: str,
                 now: Optional[datetime.datetime] = None
                 ) -> dict[str, str]:
    """Return headers + SigV4 authorization for the request.

    host must include ":port" when non-default: SigV4 signs the Host
    header exactly as transmitted (http.client sends host:port then).
    path must be the URL-encoded absolute path.  The input headers dict is
    not mutated; header names are lower-cased in the result.
    """
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date_stamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(body).hexdigest()

    out = {k.lower(): v for k, v in headers.items()}
    out["host"] = host
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash

    signed = ";".join(sorted(out))
    canonical = "\n".join([
        method, path, canonical_query(query),
        "".join(f"{k}:{' '.join(out[k].split())}\n" for k in sorted(out)),
        signed, payload_hash,
    ])
    scope = f"{date_stamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest(),
    ])
    k = _hm(_hm(_hm(_hm(b"AWS4" + secret_key.encode(), date_stamp),
                    region), service), "aws4_request")
    signature = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    out["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={signature}"
    )
    return out
