from .snr import snr_db  # noqa: F401
from .cplx import c2ri, ri2c, np_ri2c, np_c2ri  # noqa: F401
