"""The oracle for the symmetric-contraction kernels (port of the JAX
package's ``kernels/symmetric_contraction/ref.py``): the dense-U einsum of
:func:`repro_torch.core.symmetric_contraction.symcon_ref`, i.e. the
mathematical definition, not the sparse-table form (itself held against
this same oracle)."""
from repro_torch.core.symmetric_contraction import symcon_ref as symcon_reference  # noqa: F401
