from fhe_regex_tpu_torch.crypto.keys import (  # noqa: F401
    ClientKey,
    ServerKey,
    gen_keys,
    load_client_key,
    save_client_key,
)
from fhe_regex_tpu_torch.crypto.lwe import (  # noqa: F401
    decode,
    decrypt_lwe,
    encode,
    encrypt_lwe,
    trivial_lwe,
)
