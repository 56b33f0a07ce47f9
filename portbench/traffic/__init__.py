"""One driver per traffic kind; the mixes are the ``*.json`` files here."""
