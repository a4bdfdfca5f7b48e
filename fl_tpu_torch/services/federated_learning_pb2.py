# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: federated_learning.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x18\x66\x65\x64\x65rated_learning.proto\x12\x12\x66\x65\x64\x65rated_learning\"`\n\rPrivacyConfig\x12\x0f\n\x07\x65psilon\x18\x01 \x01(\x01\x12\r\n\x05\x64\x65lta\x18\x02 \x01(\x01\x12\x15\n\rmax_grad_norm\x18\x03 \x01(\x01\x12\x18\n\x10noise_multiplier\x18\x04 \x01(\x01\"k\n\nDeviceInfo\x12\x13\n\x0b\x64\x65vice_type\x18\x01 \x01(\t\x12\x11\n\tmemory_gb\x18\x02 \x01(\x05\x12\x11\n\tcpu_cores\x18\x03 \x01(\x05\x12\x0f\n\x07has_gpu\x18\x04 \x01(\x08\x12\x11\n\tgpu_model\x18\x05 \x01(\t\"\x9d\x02\n\x12\x43lientCapabilities\x12<\n\rcompute_power\x18\x01 \x01(\x0e\x32%.federated_learning.ComputePowerLevel\x12\x1e\n\x16network_bandwidth_mbps\x18\x02 \x01(\x05\x12\x19\n\x11\x61vailable_samples\x18\x03 \x01(\x05\x12\x18\n\x10supported_models\x18\x04 \x03(\t\x12?\n\x14privacy_requirements\x18\x05 \x01(\x0b\x32!.federated_learning.PrivacyConfig\x12\x33\n\x0b\x64\x65vice_info\x18\x06 \x01(\x0b\x32\x1e.federated_learning.DeviceInfo\"\xf6\x01\n\x12\x43lientRegistration\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12<\n\x0c\x63\x61pabilities\x18\x02 \x01(\x0b\x32&.federated_learning.ClientCapabilities\x12\x16\n\x0e\x63lient_version\x18\x03 \x01(\t\x12\x46\n\x08metadata\x18\x04 \x03(\x0b\x32\x34.federated_learning.ClientRegistration.MetadataEntry\x1a/\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x9d\x01\n\nServerInfo\x12\x16\n\x0eserver_version\x18\x01 \x01(\t\x12\x18\n\x10supported_models\x18\x02 \x03(\t\x12\x1a\n\x12supported_datasets\x18\x03 \x03(\t\x12\x41\n\x16\x64\x65\x66\x61ult_privacy_config\x18\x04 \x01(\x0b\x32!.federated_learning.PrivacyConfig\"\xa7\x01\n\x14RegistrationResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x1a\n\x12\x61ssigned_client_id\x18\x03 \x01(\t\x12\x1c\n\x14global_model_version\x18\x04 \x01(\x05\x12\x33\n\x0bserver_info\x18\x05 \x01(\x0b\x32\x1e.federated_learning.ServerInfo\"K\n\x0cModelRequest\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12\x14\n\x0cround_number\x18\x02 \x01(\x05\x12\x12\n\nmodel_type\x18\x03 \x01(\t\"\x9a\x02\n\rModelMetadata\x12\x12\n\nmodel_type\x18\x01 \x01(\t\x12\x17\n\x0fparameter_count\x18\x02 \x01(\x05\x12\x18\n\x10model_size_bytes\x18\x03 \x01(\x03\x12\x1d\n\x15\x63ompression_algorithm\x18\x04 \x01(\t\x12\x19\n\x11\x63ompression_ratio\x18\x05 \x01(\x01\x12P\n\x10\x61\x63\x63uracy_metrics\x18\x06 \x03(\x0b\x32\x36.federated_learning.ModelMetadata.AccuracyMetricsEntry\x1a\x36\n\x14\x41\x63\x63uracyMetricsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"\x93\x01\n\rModelResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x15\n\rmodel_weights\x18\x03 \x01(\x0c\x12\x14\n\x0cround_number\x18\x04 \x01(\x05\x12\x33\n\x08metadata\x18\x05 \x01(\x0b\x32!.federated_learning.ModelMetadata\"\x97\x02\n\x0fTrainingMetrics\x12\x0c\n\x04loss\x18\x01 \x01(\x01\x12\x10\n\x08\x61\x63\x63uracy\x18\x02 \x01(\x01\x12\x18\n\x10\x65pochs_completed\x18\x03 \x01(\x05\x12\x1d\n\x15training_time_seconds\x18\x04 \x01(\x01\x12\x19\n\x11samples_processed\x18\x05 \x01(\x05\x12V\n\x12\x61\x64\x64itional_metrics\x18\x06 \x03(\x0b\x32:.federated_learning.TrainingMetrics.AdditionalMetricsEntry\x1a\x38\n\x16\x41\x64\x64itionalMetricsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"\xbd\x01\n\x0eUpdateMetadata\x12\x1d\n\x15\x63ompression_algorithm\x18\x01 \x01(\t\x12\x1b\n\x13original_size_bytes\x18\x02 \x01(\x03\x12\x1d\n\x15\x63ompressed_size_bytes\x18\x03 \x01(\x03\x12\x1c\n\x14privacy_epsilon_used\x18\x04 \x01(\x01\x12\x1a\n\x12privacy_delta_used\x18\x05 \x01(\x01\x12\x16\n\x0e\x63lient_version\x18\x06 \x01(\t\"\xb9\x02\n\x0bModelUpdate\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12\x14\n\x0cround_number\x18\x02 \x01(\x05\x12\x15\n\rmodel_weights\x18\x03 \x01(\x0c\x12\x13\n\x0bnum_samples\x18\x04 \x01(\x05\x12\x15\n\rtraining_loss\x18\x05 \x01(\x01\x12\x1b\n\x13privacy_budget_used\x18\x06 \x01(\x01\x12\x19\n\x11\x63ompression_ratio\x18\x07 \x01(\x01\x12\x11\n\ttimestamp\x18\x08 \x01(\x03\x12=\n\x10training_metrics\x18\t \x01(\x0b\x32#.federated_learning.TrainingMetrics\x12\x34\n\x08metadata\x18\n \x01(\x0b\x32\".federated_learning.UpdateMetadata\"|\n\tUpdateAck\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x16\n\x0enext_round_eta\x18\x03 \x01(\x03\x12\x35\n\x0cround_status\x18\x04 \x01(\x0e\x32\x1f.federated_learning.RoundStatus\">\n\x10RoundJoinRequest\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12\x17\n\x0frequested_round\x18\x02 \x01(\x05\"\x85\x03\n\x0bRoundConfig\x12\x14\n\x0cround_number\x18\x01 \x01(\x05\x12\x13\n\x0bmin_clients\x18\x02 \x01(\x05\x12\x13\n\x0bmax_clients\x18\x03 \x01(\x05\x12\x14\n\x0clocal_epochs\x18\x04 \x01(\x05\x12\x12\n\nbatch_size\x18\x05 \x01(\x05\x12\x15\n\rlearning_rate\x18\x06 \x01(\x01\x12\x17\n\x0ftimeout_seconds\x18\x07 \x01(\x05\x12\x16\n\x0eoptimizer_type\x18\x08 \x01(\t\x12\x39\n\x0eprivacy_config\x18\t \x01(\x0b\x32!.federated_learning.PrivacyConfig\x12P\n\x11\x61\x64\x64itional_params\x18\n \x03(\x0b\x32\x35.federated_learning.RoundConfig.AdditionalParamsEntry\x1a\x37\n\x15\x41\x64\x64itionalParamsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x84\x01\n\x11RoundJoinResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x16\n\x0e\x61ssigned_round\x18\x03 \x01(\x05\x12\x35\n\x0cround_config\x18\x04 \x01(\x0b\x32\x1f.federated_learning.RoundConfig\"=\n\x12RoundConfigRequest\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12\x14\n\x0cround_number\x18\x02 \x01(\x05\"\"\n\rStatusRequest\x12\x11\n\tclient_id\x18\x01 \x01(\t\"\xb2\x01\n\x0c\x43lientStatus\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12.\n\x05state\x18\x02 \x01(\x0e\x32\x1f.federated_learning.ClientState\x12\x15\n\rlast_accuracy\x18\x03 \x01(\x01\x12\x11\n\tlast_loss\x18\x04 \x01(\x01\x12\x18\n\x10last_update_time\x18\x05 \x01(\x03\x12\x1b\n\x13rounds_participated\x18\x06 \x01(\x05\"\x9b\x02\n\x0eTrainingStatus\x12\x15\n\rcurrent_round\x18\x01 \x01(\x05\x12\x16\n\x0e\x61\x63tive_clients\x18\x02 \x01(\x05\x12\x16\n\x0eround_progress\x18\x03 \x01(\x01\x12\x17\n\x0fglobal_accuracy\x18\x04 \x01(\x01\x12\x19\n\x11\x63onvergence_score\x18\x05 \x01(\x01\x12\x1c\n\x14\x65stimated_completion\x18\x06 \x01(\x03\x12\x35\n\x0cround_status\x18\x07 \x01(\x0e\x32\x1f.federated_learning.RoundStatus\x12\x39\n\x0f\x63lient_statuses\x18\x08 \x03(\x0b\x32 .federated_learning.ClientStatus\"%\n\rHealthRequest\x12\x14\n\x0cservice_name\x18\x01 \x01(\t\"\xb6\x01\n\x0eHealthResponse\x12\x0f\n\x07healthy\x18\x01 \x01(\x08\x12\x0e\n\x06status\x18\x02 \x01(\t\x12@\n\x07\x64\x65tails\x18\x03 \x03(\x0b\x32/.federated_learning.HealthResponse.DetailsEntry\x12\x11\n\ttimestamp\x18\x04 \x01(\x03\x1a.\n\x0c\x44\x65tailsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"_\n\x0eMetricsRequest\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12\x14\n\x0cmetric_names\x18\x02 \x03(\t\x12\x12\n\nstart_time\x18\x03 \x01(\x03\x12\x10\n\x08\x65nd_time\x18\x04 \x01(\x03\"\x9b\x01\n\x0bMetricPoint\x12\x11\n\ttimestamp\x18\x01 \x01(\x03\x12\r\n\x05value\x18\x02 \x01(\x01\x12;\n\x06labels\x18\x03 \x03(\x0b\x32+.federated_learning.MetricPoint.LabelsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"R\n\nMetricData\x12\x13\n\x0bmetric_name\x18\x01 \x01(\t\x12/\n\x06points\x18\x02 \x03(\x0b\x32\x1f.federated_learning.MetricPoint\"\xb5\x01\n\x0fMetricsResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x41\n\x07metrics\x18\x02 \x03(\x0b\x32\x30.federated_learning.MetricsResponse.MetricsEntry\x1aN\n\x0cMetricsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12-\n\x05value\x18\x02 \x01(\x0b\x32\x1e.federated_learning.MetricData:\x02\x38\x01\"2\n\x0eUpdateResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\"\xa9\x01\n\x0c\x45rrorDetails\x12\x12\n\nerror_code\x18\x01 \x01(\t\x12\x15\n\rerror_message\x18\x02 \x01(\t\x12>\n\x07\x63ontext\x18\x03 \x03(\x0b\x32-.federated_learning.ErrorDetails.ContextEntry\x1a.\n\x0c\x43ontextEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\">\n\x13SecAggRosterRequest\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12\x14\n\x0cround_number\x18\x02 \x01(\x05\"3\n\nSecAggPeer\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12\x12\n\npublic_key\x18\x02 \x01(\x0c\"\xaf\x01\n\x0cSecAggRoster\x12\r\n\x05ready\x18\x01 \x01(\x08\x12\x14\n\x0cround_number\x18\x02 \x01(\x05\x12-\n\x05peers\x18\x03 \x03(\x0b\x32\x1e.federated_learning.SecAggPeer\x12\x0f\n\x07message\x18\x04 \x01(\t\x12\x14\n\x0croster_nonce\x18\x05 \x01(\x0c\x12\x11\n\tthreshold\x18\x06 \x01(\r\x12\x11\n\tfrac_bits\x18\x07 \x01(\r\"O\n\x0bSecAggShare\x12\x16\n\x0e\x66rom_client_id\x18\x01 \x01(\t\x12\x14\n\x0cto_client_id\x18\x02 \x01(\t\x12\x12\n\nciphertext\x18\x03 \x01(\x0c\"\x83\x01\n\x11SecAggShareUpload\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12\x14\n\x0cround_number\x18\x02 \x01(\x05\x12\x14\n\x0croster_nonce\x18\x03 \x01(\x0c\x12/\n\x06shares\x18\x04 \x03(\x0b\x32\x1f.federated_learning.SecAggShare\"f\n\x13SecAggShareDownload\x12\r\n\x05ready\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12/\n\x06shares\x18\x03 \x03(\x0b\x32\x1f.federated_learning.SecAggShare\">\n\x13SecAggRevealRequest\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12\x14\n\x0cround_number\x18\x02 \x01(\x05\"l\n\x10SecAggRevealInfo\x12\r\n\x05ready\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\x14\n\x0croster_nonce\x18\x03 \x01(\x0c\x12\x11\n\tsurvivors\x18\x04 \x03(\t\x12\x0f\n\x07\x64ropped\x18\x05 \x03(\t\"U\n\x13SecAggRevealedShare\x12\x19\n\x11subject_client_id\x18\x01 \x01(\t\x12\x14\n\x0cis_key_share\x18\x02 \x01(\x08\x12\r\n\x05share\x18\x03 \x01(\x0c\"\x8c\x01\n\x12SecAggRevealUpload\x12\x11\n\tclient_id\x18\x01 \x01(\t\x12\x14\n\x0cround_number\x18\x02 \x01(\x05\x12\x14\n\x0croster_nonce\x18\x03 \x01(\x0c\x12\x37\n\x06shares\x18\x04 \x03(\x0b\x32\'.federated_learning.SecAggRevealedShare*w\n\x11\x43omputePowerLevel\x12\x19\n\x15\x43OMPUTE_POWER_UNKNOWN\x10\x00\x12\x15\n\x11\x43OMPUTE_POWER_LOW\x10\x01\x12\x18\n\x14\x43OMPUTE_POWER_MEDIUM\x10\x02\x12\x16\n\x12\x43OMPUTE_POWER_HIGH\x10\x03*\x99\x01\n\x0bRoundStatus\x12\x18\n\x14ROUND_STATUS_UNKNOWN\x10\x00\x12\x18\n\x14ROUND_STATUS_WAITING\x10\x01\x12\x1c\n\x18ROUND_STATUS_IN_PROGRESS\x10\x02\x12\x1c\n\x18ROUND_STATUS_AGGREGATING\x10\x03\x12\x1a\n\x16ROUND_STATUS_COMPLETED\x10\x04*\xb4\x01\n\x0b\x43lientState\x12\x18\n\x14\x43LIENT_STATE_UNKNOWN\x10\x00\x12\x1b\n\x17\x43LIENT_STATE_REGISTERED\x10\x01\x12\x19\n\x15\x43LIENT_STATE_TRAINING\x10\x02\x12\x1a\n\x16\x43LIENT_STATE_UPLOADING\x10\x03\x12\x18\n\x14\x43LIENT_STATE_WAITING\x10\x04\x12\x1d\n\x19\x43LIENT_STATE_DISCONNECTED\x10\x05\x32\xb9\n\n\x11\x46\x65\x64\x65ratedLearning\x12\x62\n\x0eRegisterClient\x12&.federated_learning.ClientRegistration\x1a(.federated_learning.RegistrationResponse\x12\x66\n\x18UpdateClientCapabilities\x12&.federated_learning.ClientCapabilities\x1a\".federated_learning.UpdateResponse\x12Z\n\x11GetTrainingStatus\x12!.federated_learning.StatusRequest\x1a\".federated_learning.TrainingStatus\x12U\n\x0eGetGlobalModel\x12 .federated_learning.ModelRequest\x1a!.federated_learning.ModelResponse\x12S\n\x11SubmitModelUpdate\x12\x1f.federated_learning.ModelUpdate\x1a\x1d.federated_learning.UpdateAck\x12`\n\x11JoinTrainingRound\x12$.federated_learning.RoundJoinRequest\x1a%.federated_learning.RoundJoinResponse\x12Y\n\x0eGetRoundConfig\x12&.federated_learning.RoundConfigRequest\x1a\x1f.federated_learning.RoundConfig\x12T\n\x0bHealthCheck\x12!.federated_learning.HealthRequest\x1a\".federated_learning.HealthResponse\x12U\n\nGetMetrics\x12\".federated_learning.MetricsRequest\x1a#.federated_learning.MetricsResponse\x12\\\n\x0fGetSecAggRoster\x12\'.federated_learning.SecAggRosterRequest\x1a .federated_learning.SecAggRoster\x12_\n\x12SubmitSecAggShares\x12%.federated_learning.SecAggShareUpload\x1a\".federated_learning.UpdateResponse\x12\x63\n\x0fGetSecAggShares\x12\'.federated_learning.SecAggRosterRequest\x1a\'.federated_learning.SecAggShareDownload\x12`\n\x0fGetSecAggReveal\x12\'.federated_learning.SecAggRevealRequest\x1a$.federated_learning.SecAggRevealInfo\x12`\n\x12SubmitSecAggReveal\x12&.federated_learning.SecAggRevealUpload\x1a\".federated_learning.UpdateResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'federated_learning_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CLIENTREGISTRATION_METADATAENTRY._options = None
  _CLIENTREGISTRATION_METADATAENTRY._serialized_options = b'8\001'
  _MODELMETADATA_ACCURACYMETRICSENTRY._options = None
  _MODELMETADATA_ACCURACYMETRICSENTRY._serialized_options = b'8\001'
  _TRAININGMETRICS_ADDITIONALMETRICSENTRY._options = None
  _TRAININGMETRICS_ADDITIONALMETRICSENTRY._serialized_options = b'8\001'
  _ROUNDCONFIG_ADDITIONALPARAMSENTRY._options = None
  _ROUNDCONFIG_ADDITIONALPARAMSENTRY._serialized_options = b'8\001'
  _HEALTHRESPONSE_DETAILSENTRY._options = None
  _HEALTHRESPONSE_DETAILSENTRY._serialized_options = b'8\001'
  _METRICPOINT_LABELSENTRY._options = None
  _METRICPOINT_LABELSENTRY._serialized_options = b'8\001'
  _METRICSRESPONSE_METRICSENTRY._options = None
  _METRICSRESPONSE_METRICSENTRY._serialized_options = b'8\001'
  _ERRORDETAILS_CONTEXTENTRY._options = None
  _ERRORDETAILS_CONTEXTENTRY._serialized_options = b'8\001'
  _COMPUTEPOWERLEVEL._serialized_start=5696
  _COMPUTEPOWERLEVEL._serialized_end=5815
  _ROUNDSTATUS._serialized_start=5818
  _ROUNDSTATUS._serialized_end=5971
  _CLIENTSTATE._serialized_start=5974
  _CLIENTSTATE._serialized_end=6154
  _PRIVACYCONFIG._serialized_start=48
  _PRIVACYCONFIG._serialized_end=144
  _DEVICEINFO._serialized_start=146
  _DEVICEINFO._serialized_end=253
  _CLIENTCAPABILITIES._serialized_start=256
  _CLIENTCAPABILITIES._serialized_end=541
  _CLIENTREGISTRATION._serialized_start=544
  _CLIENTREGISTRATION._serialized_end=790
  _CLIENTREGISTRATION_METADATAENTRY._serialized_start=743
  _CLIENTREGISTRATION_METADATAENTRY._serialized_end=790
  _SERVERINFO._serialized_start=793
  _SERVERINFO._serialized_end=950
  _REGISTRATIONRESPONSE._serialized_start=953
  _REGISTRATIONRESPONSE._serialized_end=1120
  _MODELREQUEST._serialized_start=1122
  _MODELREQUEST._serialized_end=1197
  _MODELMETADATA._serialized_start=1200
  _MODELMETADATA._serialized_end=1482
  _MODELMETADATA_ACCURACYMETRICSENTRY._serialized_start=1428
  _MODELMETADATA_ACCURACYMETRICSENTRY._serialized_end=1482
  _MODELRESPONSE._serialized_start=1485
  _MODELRESPONSE._serialized_end=1632
  _TRAININGMETRICS._serialized_start=1635
  _TRAININGMETRICS._serialized_end=1914
  _TRAININGMETRICS_ADDITIONALMETRICSENTRY._serialized_start=1858
  _TRAININGMETRICS_ADDITIONALMETRICSENTRY._serialized_end=1914
  _UPDATEMETADATA._serialized_start=1917
  _UPDATEMETADATA._serialized_end=2106
  _MODELUPDATE._serialized_start=2109
  _MODELUPDATE._serialized_end=2422
  _UPDATEACK._serialized_start=2424
  _UPDATEACK._serialized_end=2548
  _ROUNDJOINREQUEST._serialized_start=2550
  _ROUNDJOINREQUEST._serialized_end=2612
  _ROUNDCONFIG._serialized_start=2615
  _ROUNDCONFIG._serialized_end=3004
  _ROUNDCONFIG_ADDITIONALPARAMSENTRY._serialized_start=2949
  _ROUNDCONFIG_ADDITIONALPARAMSENTRY._serialized_end=3004
  _ROUNDJOINRESPONSE._serialized_start=3007
  _ROUNDJOINRESPONSE._serialized_end=3139
  _ROUNDCONFIGREQUEST._serialized_start=3141
  _ROUNDCONFIGREQUEST._serialized_end=3202
  _STATUSREQUEST._serialized_start=3204
  _STATUSREQUEST._serialized_end=3238
  _CLIENTSTATUS._serialized_start=3241
  _CLIENTSTATUS._serialized_end=3419
  _TRAININGSTATUS._serialized_start=3422
  _TRAININGSTATUS._serialized_end=3705
  _HEALTHREQUEST._serialized_start=3707
  _HEALTHREQUEST._serialized_end=3744
  _HEALTHRESPONSE._serialized_start=3747
  _HEALTHRESPONSE._serialized_end=3929
  _HEALTHRESPONSE_DETAILSENTRY._serialized_start=3883
  _HEALTHRESPONSE_DETAILSENTRY._serialized_end=3929
  _METRICSREQUEST._serialized_start=3931
  _METRICSREQUEST._serialized_end=4026
  _METRICPOINT._serialized_start=4029
  _METRICPOINT._serialized_end=4184
  _METRICPOINT_LABELSENTRY._serialized_start=4139
  _METRICPOINT_LABELSENTRY._serialized_end=4184
  _METRICDATA._serialized_start=4186
  _METRICDATA._serialized_end=4268
  _METRICSRESPONSE._serialized_start=4271
  _METRICSRESPONSE._serialized_end=4452
  _METRICSRESPONSE_METRICSENTRY._serialized_start=4374
  _METRICSRESPONSE_METRICSENTRY._serialized_end=4452
  _UPDATERESPONSE._serialized_start=4454
  _UPDATERESPONSE._serialized_end=4504
  _ERRORDETAILS._serialized_start=4507
  _ERRORDETAILS._serialized_end=4676
  _ERRORDETAILS_CONTEXTENTRY._serialized_start=4630
  _ERRORDETAILS_CONTEXTENTRY._serialized_end=4676
  _SECAGGROSTERREQUEST._serialized_start=4678
  _SECAGGROSTERREQUEST._serialized_end=4740
  _SECAGGPEER._serialized_start=4742
  _SECAGGPEER._serialized_end=4793
  _SECAGGROSTER._serialized_start=4796
  _SECAGGROSTER._serialized_end=4971
  _SECAGGSHARE._serialized_start=4973
  _SECAGGSHARE._serialized_end=5052
  _SECAGGSHAREUPLOAD._serialized_start=5055
  _SECAGGSHAREUPLOAD._serialized_end=5186
  _SECAGGSHAREDOWNLOAD._serialized_start=5188
  _SECAGGSHAREDOWNLOAD._serialized_end=5290
  _SECAGGREVEALREQUEST._serialized_start=5292
  _SECAGGREVEALREQUEST._serialized_end=5354
  _SECAGGREVEALINFO._serialized_start=5356
  _SECAGGREVEALINFO._serialized_end=5464
  _SECAGGREVEALEDSHARE._serialized_start=5466
  _SECAGGREVEALEDSHARE._serialized_end=5551
  _SECAGGREVEALUPLOAD._serialized_start=5554
  _SECAGGREVEALUPLOAD._serialized_end=5694
  _FEDERATEDLEARNING._serialized_start=6157
  _FEDERATEDLEARNING._serialized_end=7494
# @@protoc_insertion_point(module_scope)
