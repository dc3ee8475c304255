"""Training data: the image-folder dataset and the native resize library.
Import from the submodules."""
