"""Inputs of the port (copies of the JAX package's host code): prompt
synthesis for serving, synthetic image and token batches for training,
ImageNet TFRecords (``tfrecord``, ``imagenet``) and token corpora
(``tokens``) for the real-data runs, and ``feed``, which moves host
batches onto the card."""
