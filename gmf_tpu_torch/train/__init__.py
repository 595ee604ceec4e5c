"""PointDSC+GMF training: losses, the train and eval steps, the trainer
and its command line (``python -m gmf_tpu_torch.train.train_pointdsc``)."""
