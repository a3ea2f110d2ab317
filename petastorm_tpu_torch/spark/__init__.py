"""DataFrame -> cached Parquet -> the port's loader
(:mod:`petastorm_tpu_torch.spark.spark_dataset_converter`)."""
