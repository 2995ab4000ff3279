"""VGG encoder, attention pooling and the embedding trunk."""
