"""Host-side transforms run before and after the codec: the word-replacing
dictionary and the enwik9-style Wikipedia-dump preprocessing, copied from
`gmix_tpu.preprocess` with their C++ engines and assets."""
from . import dictionary  # noqa: F401
