"""Compute ops: the batched equivalents of the reference's OpenCV/DBoW2 hot
loops (image pyramid, FAST, BRIEF, Hamming matching, stereo SAD)."""
