"""One driver a family of train step, found by the name a configuration gives."""
