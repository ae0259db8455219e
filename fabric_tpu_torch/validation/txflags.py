"""Alias of `fabric_tpu_torch.common.txflags`, under the path the JAX
package's `validation/txflags` has: TxValidationCode and ValidationFlags
live in the lowest shared layer, and this module makes
``fabric_tpu_torch.validation.txflags is fabric_tpu_torch.common.txflags``.
"""

import sys as _sys

from fabric_tpu_torch.common import txflags as _impl

_sys.modules[__name__] = _impl
