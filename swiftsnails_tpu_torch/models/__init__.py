"""Trainers of the port; importing this package registers them."""

from swiftsnails_tpu_torch.models import fm, logreg, widedeep, word2vec  # noqa: F401
