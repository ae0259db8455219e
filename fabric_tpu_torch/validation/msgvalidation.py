"""Alias of `fabric_tpu_torch.ledger.txparse`, under the path the JAX
package's `validation/msgvalidation` has: the structural tx parser
(ParsedTx, SigJob, parse_transaction, parse_tx_rwset) lives beside the
rwset types it builds, and this module makes
``fabric_tpu_torch.validation.msgvalidation is fabric_tpu_torch.ledger.txparse``.
"""

import sys as _sys

from fabric_tpu_torch.ledger import txparse as _impl

_sys.modules[__name__] = _impl
